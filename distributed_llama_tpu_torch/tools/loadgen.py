"""Seeded, replayable workload generator + engine and HTTP replays (the
port's copy of the repository's tools/loadgen.py; traces and records are
that tool's, byte for byte).

Serving is judged at OFFERED LOAD — arrivals the system does not control
— not with back-to-back benchmark batches. This module produces that
traffic three ways deterministic enough to gate on:

* **generate**: a ``LoadSpec`` (arrival process, prompt/output length
  distributions, shared-prefix mix, SLO class mix) plus a seed yields a
  ``Trace`` — the exact arrival schedule with fully materialized token
  ids. Same spec + same seed = identical trace, bit for bit.
* **record/replay**: ``save_trace``/``load_trace`` round-trip a trace as
  JSON, so a schedule can be archived and replayed against any later
  engine build.
* **drive**: ``drive_engine`` replays a trace against an in-process
  ``ContinuousEngine`` on a VIRTUAL clock (one device dispatch = a fixed
  time cost), deriving per-request SLO verdicts from step-count
  timestamps — deterministic on any device whose token streams agree,
  which is what lets tools/loadcheck.py hold goodput to a checked-in
  band. ``drive_pools`` is its two-pool (colocated or disaggregated)
  twin. ``drive_http`` replays against a live runtime/server.py on the
  wall clock (client-observed TTFT = first streamed token).

Arrival processes:

* ``poisson`` — i.i.d. exponential gaps at ``rate`` (the classic open-loop
  model);
* ``bursty`` — a two-state Markov-modulated Poisson process: a calm state
  at ``rate`` and a burst state at ``rate * burst_rate_x``, switching
  state per arrival with the configured probabilities: long quiet
  stretches that let the pool drain, then clumps that slam admission all
  at once.

The shared-prefix mix emits a configurable fraction of prompts opening
with one of ``n_shared_prefixes`` fixed system prompts (length chosen to
page-align) — the radix-tree exercise: under prefix sharing these
admissions should hit shared pages instead of re-prefilling.
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
import time
import urllib.request

BOS = 1           # io.tokenizer.BOS; traces are raw token ids
_ID_LO = 3        # first generated body id (avoid BOS and pad-ish ids)

TRACE_KIND = "dllama-load-trace"
TRACE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """Declarative workload shape; ``generate_trace(spec, seed)`` makes it
    concrete. ``rate`` is arrivals per TIME UNIT — wall seconds under
    ``drive_http``, virtual seconds (= ``step_cost_s`` per dispatch)
    under ``drive_engine``."""

    rate: float = 0.25
    n_requests: int = 32
    arrivals: str = "poisson"            # poisson | bursty
    burst_rate_x: float = 8.0            # bursty: burst-state rate multiple
    p_enter_burst: float = 0.08          # calm -> burst, checked per arrival
    p_exit_burst: float = 0.35           # burst -> calm
    prompt_lens: tuple = (4, 8, 12)      # prompt positions (BOS included)
    prompt_len_weights: tuple = ()       # uniform when empty
    out_lens: tuple = (4, 8, 16)         # generated positions on top
    out_len_weights: tuple = ()
    shared_prefix_rate: float = 0.0      # fraction opening with a shared
    #                                      system prompt (radix exercise)
    shared_prefix_len: int = 0           # positions; page-align it
    n_shared_prefixes: int = 1
    classes: tuple = ("interactive",)    # SLO class mix
    class_weights: tuple = ()
    # per-class prompt-length override: one lens tuple per
    # class (empty tuple = that class uses ``prompt_lens``). The
    # class-specific draw comes from a DERIVED rng stream, so setting
    # this never reshuffles a default trace — the loadcheck baseline's
    # traces stay bit-identical. This is how the two-pool sweep gets its
    # mixed trace: short interactive prompts, long batch prompts.
    class_prompt_lens: tuple = ()
    vocab: int = 128                     # body ids in [3, vocab)
    seq_len: int = 0                     # >0: clamp prompt+out to this

    def __post_init__(self):
        if self.arrivals not in ("poisson", "bursty"):
            raise ValueError(f"unknown arrival process {self.arrivals!r}")
        if self.rate <= 0 or self.n_requests < 1:
            raise ValueError("rate must be > 0 and n_requests >= 1")
        if self.shared_prefix_rate > 0 and self.shared_prefix_len < 1:
            raise ValueError("shared_prefix_rate needs shared_prefix_len")
        if self.class_prompt_lens \
                and len(self.class_prompt_lens) != len(self.classes):
            raise ValueError(
                f"class_prompt_lens needs one entry per class "
                f"({len(self.classes)}), got "
                f"{len(self.class_prompt_lens)}")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    t: float              # arrival time (time units from trace start)
    tokens: tuple         # full prompt, BOS included
    steps: int            # position budget (prompt + output)
    slo_class: str


@dataclasses.dataclass
class Trace:
    seed: int
    spec: dict            # LoadSpec provenance (asdict)
    events: list          # [TraceEvent], sorted by t

    @property
    def offered_rate(self) -> float:
        """Measured arrivals per time unit over the trace span."""
        if len(self.events) < 2:
            return 0.0
        span = self.events[-1].t - self.events[0].t
        return (len(self.events) - 1) / span if span > 0 else 0.0


def _choice(rng: random.Random, values, weights):
    if weights:
        return rng.choices(list(values), weights=list(weights), k=1)[0]
    return values[rng.randrange(len(values))]


def generate_trace(spec: LoadSpec, seed: int) -> Trace:
    """Materialize a spec: arrival schedule + token ids + budgets + class
    labels, all from one ``random.Random(seed)`` stream (stdlib Mersenne
    Twister — stable across platforms and Python versions by contract)."""
    rng = random.Random(seed)
    # fixed shared system prompts from a DERIVED stream, so toggling the
    # mix rate does not reshuffle every other draw
    prefix_rng = random.Random(seed ^ 0x5EED)
    # class-specific prompt lengths likewise ride their own stream: a
    # spec without class_prompt_lens generates the exact bytes it always
    # did (the loadcheck baseline's determinism contract)
    len_rng = random.Random(seed ^ 0xC1A55)
    prefixes = [tuple(prefix_rng.randrange(_ID_LO, spec.vocab)
                      for _ in range(spec.shared_prefix_len))
                for _ in range(max(1, spec.n_shared_prefixes))]
    events = []
    t = 0.0
    burst = False
    for _ in range(spec.n_requests):
        if spec.arrivals == "bursty":
            if burst:
                burst = rng.random() >= spec.p_exit_burst
            else:
                burst = rng.random() < spec.p_enter_burst
            rate = spec.rate * (spec.burst_rate_x if burst else 1.0)
        else:
            rate = spec.rate
        t += rng.expovariate(rate)
        p_len = int(_choice(rng, spec.prompt_lens, spec.prompt_len_weights))
        o_len = int(_choice(rng, spec.out_lens, spec.out_len_weights))
        body: list = []
        slo_class = str(_choice(rng, spec.classes, spec.class_weights))
        if spec.class_prompt_lens:
            lens = spec.class_prompt_lens[spec.classes.index(slo_class)]
            if lens:
                p_len = int(_choice(len_rng, tuple(lens), ()))
        if (spec.shared_prefix_rate > 0
                and rng.random() < spec.shared_prefix_rate):
            body += list(prefixes[rng.randrange(len(prefixes))])
        while len(body) < p_len - 1:
            body.append(rng.randrange(_ID_LO, spec.vocab))
        tokens = tuple([BOS] + body)
        steps = len(tokens) + o_len
        if spec.seq_len:
            steps = min(steps, spec.seq_len)
        events.append(TraceEvent(t=round(t, 9), tokens=tokens,
                                 steps=steps, slo_class=slo_class))
    return Trace(seed=seed, spec=dataclasses.asdict(spec), events=events)


def save_trace(trace: Trace, path: str) -> None:
    doc = {"kind": TRACE_KIND, "version": TRACE_VERSION,
           "seed": trace.seed, "spec": trace.spec,
           "events": [{"t": e.t, "tokens": list(e.tokens),
                       "steps": e.steps, "class": e.slo_class}
                      for e in trace.events]}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
        fh.write("\n")


def load_trace(path: str) -> Trace:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("kind") != TRACE_KIND:
        raise ValueError(f"{path}: not a {TRACE_KIND} file")
    if doc.get("version") != TRACE_VERSION:
        raise ValueError(f"{path}: trace version {doc.get('version')}, "
                         f"this build reads {TRACE_VERSION}")
    events = [TraceEvent(t=float(e["t"]), tokens=tuple(e["tokens"]),
                         steps=int(e["steps"]),
                         slo_class=str(e["class"]))
              for e in doc["events"]]
    return Trace(seed=int(doc["seed"]), spec=dict(doc["spec"]),
                 events=events)


# ---------------------------------------------------------------- replays


@dataclasses.dataclass
class RequestRecord:
    """One replayed request's lifecycle on the replay's clock."""

    index: int
    slo_class: str
    arrival: float
    v_first: float | None = None    # first SAMPLED token
    v_finish: float | None = None
    n_sampled: int = 0
    tokens_out: int = 0
    error: str | None = None
    verdict: str = ""
    ttft: float | None = None
    per_token: float | None = None


@dataclasses.dataclass
class LoadResult:
    """A replay's outcome: per-request records + the aggregates loadcheck
    plots. Goodput counts sampled tokens of ``met`` requests only."""

    records: list
    duration: float
    offered_rate: float
    by_class: dict           # class -> {verdict: n}
    goodput_tokens: int
    engine: dict             # pauses/requeues/steps/prefix stats

    @property
    def goodput_tps(self) -> float:
        return self.goodput_tokens / max(self.duration, 1e-9)

    @property
    def attainment(self) -> dict:
        out = {}
        for cls, counts in sorted(self.by_class.items()):
            n = sum(counts.values())
            out[cls] = round(counts.get("met", 0) / n, 4) if n else 1.0
        return out

    def verdicts(self) -> list:
        """[(index, class, verdict)] — the determinism-test fingerprint."""
        return [(r.index, r.slo_class, r.verdict) for r in self.records]

    def class_token_p99(self) -> dict:
        """Per-class p99 of the per-request mean token latency — the
        statistic the class's 'p99' budget speaks about."""
        from ..obs.metrics import summarize_values

        out = {}
        for cls in self.by_class:
            vals = [r.per_token for r in self.records
                    if r.slo_class == cls and r.per_token is not None]
            out[cls] = round(summarize_values(vals)["p99"], 6)
        return out

    def to_json(self) -> dict:
        return {
            "offered_rate": round(self.offered_rate, 6),
            "duration": round(self.duration, 6),
            "goodput_tokens": self.goodput_tokens,
            "goodput_tps": round(self.goodput_tps, 6),
            "attainment": self.attainment,
            "token_p99": self.class_token_p99(),
            "by_class": {c: dict(v) for c, v in
                         sorted(self.by_class.items())},
            "engine": dict(self.engine),
        }


def _finalize(records, policy, duration, offered) -> LoadResult:
    by_class: dict = {}
    goodput = 0
    for rec in records:
        if rec.v_first is not None:
            rec.ttft = rec.v_first - rec.arrival
        if (rec.n_sampled > 0 and rec.v_first is not None
                and rec.v_finish is not None):
            rec.per_token = ((rec.v_finish - rec.v_first)
                             / rec.n_sampled)
        c = policy.resolve(rec.slo_class)
        rec.verdict = c.evaluate(rec.ttft, rec.per_token,
                                 failed=rec.error is not None)
        cell = by_class.setdefault(c.name, {})
        cell[rec.verdict] = cell.get(rec.verdict, 0) + 1
        if rec.verdict == "met":
            goodput += rec.n_sampled
    return LoadResult(records=records, duration=duration,
                      offered_rate=offered, by_class=by_class,
                      goodput_tokens=goodput, engine={})


def drive_engine(engine, trace: Trace, policy, step_cost_s: float = 1.0,
                 max_iters: int = 1_000_000, on_tick=None) -> LoadResult:
    """Replay ``trace`` against an in-process engine on a VIRTUAL clock.

    Each scheduler iteration advances virtual time by ``step_cost_s`` per
    device step it executed (a fused K-chain costs K); arrivals are
    submitted the moment virtual time passes them; an idle engine jumps
    to the next arrival. TTFT/per-token derive from these virtual stamps
    through the SAME ``SLOClass.evaluate`` as the wall-clock path —
    deterministic verdicts on any box (the loadcheck CI property).

    First-token resolution is one scheduler iteration (the replay sees
    ``t_first_token`` after the step that produced it) — identical across
    runs, which is what the determinism gate pins. Call on a FRESH
    engine; the replay owns the scheduler loop (no server thread).

    ``on_tick(v, finished)`` — when given — is called once per scheduler
    iteration after the live-scan with the virtual time and the records
    that finished THIS iteration (verdicts still pending: callers that
    need them evaluate incrementally via ``policy.resolve(...)``, the
    watchtower feed in fleetcheck/watchcheck does exactly this)."""
    from ..runtime.continuous import Request

    events = sorted(trace.events, key=lambda e: e.t)
    records = [RequestRecord(index=i, slo_class=e.slo_class, arrival=e.t)
               for i, e in enumerate(events)]
    v = 0.0
    i = 0
    live: list = []
    for _ in range(max_iters):
        if not live and i < len(events) and events[i].t > v:
            v = events[i].t  # idle: jump to the next arrival
        while i < len(events) and events[i].t <= v:
            e = events[i]
            req = Request(tokens=list(e.tokens), steps=e.steps,
                          slo_class=e.slo_class)
            engine.submit(req)
            live.append((req, records[i]))
            i += 1
        before = engine.stats.steps
        o0 = engine.stats.overrun_steps
        engine.step_many(engine.block_steps, quiet=True)
        # an overrun dispatch (mixed window packed past the token budget)
        # costs its extra device-step equivalents: the virtual
        # clock charges ceil(span/budget)-1 on top, so a scheduler that
        # cheats the budget LOSES latency instead of gaming the gate
        v += step_cost_s * ((engine.stats.steps - before)
                            + (engine.stats.overrun_steps - o0))
        still = []
        finished = []
        for req, rec in live:
            if rec.v_first is None and req.t_first_token:
                rec.v_first = v
            if req.done.is_set():
                rec.v_finish = v
                rec.n_sampled = req.n_sampled
                rec.tokens_out = len(req.out)
                rec.error = req.error
                finished.append(rec)
            else:
                still.append((req, rec))
        live = still
        if on_tick is not None:
            on_tick(v, finished)
        if not live and i >= len(events):
            break
    else:
        raise RuntimeError(
            f"drive_engine: {len(live)} requests still live after "
            f"{max_iters} iterations — the engine is not draining")
    result = _finalize(records, policy, duration=max(v, 1e-9),
                       offered=trace.offered_rate)
    st = engine.stats
    result.engine = {"steps": st.steps, "pauses": st.pauses,
                     "requeues": st.requeues,
                     "max_active": st.max_active,
                     "avg_active": round(st.avg_active, 4),
                     "overrun_steps": st.overrun_steps}
    if engine.allocator is not None:
        a = engine.allocator
        result.engine.update(prefix_hits=a.prefix_hits,
                             prefix_hit_rate=round(a.hit_rate, 4),
                             prefill_tokens_saved=a.tokens_saved,
                             evictions=a.evictions)
    return result


def drive_pools(engines, trace: Trace, policy, mode: str = "colocated",
                step_cost_s: float = 1.0, chunk_cost_s: float | None = None,
                handoff_latency_s: float = 1.0,
                handoff_page_cost_s: float = 0.25,
                route_min_pages: int = 2,
                max_iters: int = 1_000_000) -> LoadResult:
    """Deterministic TWO-POOL virtual-clock replay: each pool
    owns its own clock (they are separate hardware), one scheduler
    iteration costs ``step_cost_s`` per device step PLUS ``chunk_cost_s``
    per admission-prefill chunk — charging prefill is the whole point:
    without it, a colocated engine's prefill interference is invisible
    to the clock. Discrete-event stepping: the pool with the smaller
    clock that has work steps next; idle pools jump to their next event.

    ``mode="colocated"``: two independent full engines, arrivals
    round-robin by index — the equal-hardware baseline.
    ``mode="disagg"``: engines = (prefill, decode) — every arrival
    prefills on pool 0 (cut to prompt+1 positions), hands off as its
    journal-record state, ships its full prompt pages through the wire
    codec, and lands on pool 1 after ``handoff_latency_s +
    pages * handoff_page_cost_s`` of modeled DCN time (the decode pool
    adopts them promotion-pending and PAUSEs the request until they
    apply). Greedy traces only (a sampled handoff needs a journal for
    the coin cursor; the CI sweep is greedy).

    TTFT anchors on the pool that sampled the first token (the prefill
    pool under disagg — the DistServe split); finish stamps on the pool
    that retired the request."""
    from ..runtime.continuous import Request
    from ..runtime.disagg import (decode_request, encode_handoff_pages,
                                  entry_for_stub, export_prefix_pages,
                                  prefill_stub, stub_needs_handoff)
    from ..runtime.pagewire import decode_record, record_payload_bytes

    if mode not in ("colocated", "disagg"):
        raise ValueError(f"unknown two-pool mode {mode!r}")
    if len(engines) != 2:
        raise ValueError(f"drive_pools takes exactly 2 engines, "
                         f"got {len(engines)}")
    chunk_cost = step_cost_s if chunk_cost_s is None else chunk_cost_s
    events = sorted(trace.events, key=lambda e: e.t)
    records = [RequestRecord(index=i, slo_class=e.slo_class, arrival=e.t)
               for i, e in enumerate(events)]
    v = [0.0, 0.0]
    # per-pool arrival queues. Colocated: round-robin by event index.
    # Disagg: the ROUTING decision — prompts spanning >= route_min_pages
    # FULL pages take the prefill pool (their long prefill is the
    # interference source worth quarantining + the handoff ships real
    # pages); shorter prompts go STRAIGHT to the decode pool, where
    # their sub-threshold prefill is one cheap inline chunk — handing
    # those off would ship nothing and re-derive everything.
    waiting: list = [[], []]
    page_size = max(engines[0].page_size, 1)
    for i, e in enumerate(events):
        if mode == "disagg":
            n_full = (len(e.tokens) - 1) // page_size
            pool = 0 if n_full >= route_min_pages else 1
        else:
            pool = i % 2
        waiting[pool].append((e, records[i]))
    # live work per pool: (req, rec, sampled_before) — sampled_before is
    # the prefill stub's sampled count a disagg decode req adds to
    live: list = [[], []]
    pending: list = []  # disagg: (t_ready, entry, planes, tokens, steps,
    #                     rec, stub_sampled, payload_bytes, t_queued)

    def outstanding(k: int) -> bool:
        return engines[k]._n_outstanding() > 0

    def submit_arrivals(k: int) -> None:
        while waiting[k] and waiting[k][0][0].t <= v[k]:
            e, rec = waiting[k].pop(0)
            if mode == "disagg" and k == 0:
                req, _ = prefill_stub(list(e.tokens), e.steps,
                                      slo_class=e.slo_class)
            else:
                req = Request(tokens=list(e.tokens), steps=e.steps,
                              slo_class=e.slo_class)
            engines[k].submit(req)
            live[k].append((req, rec, 0))

    def ingest_handoffs() -> None:
        nonlocal pending
        still = []
        for item in pending:
            t_ready, entry, planes, tokens, steps, rec, n0, nbytes, \
                t_q0 = item
            if t_ready > v[1]:
                still.append(item)
                continue
            engines[1].allocator.adopt_remote_pages(
                tokens[:len(tokens) - 1], planes)
            req = decode_request(entry, steps)
            engines[1].submit(req)
            if req.ledger is not None:
                # the DCN bill + the VIRTUAL seconds this request spent
                # crossing pools (handoff initiation on the prefill clock
                # to decode admission on the decode clock — the clocks
                # share the trace's arrival epoch)
                req.ledger.charge_dcn(len(planes), nbytes)
                req.ledger.charge_stall_s("handoff_wait",
                                          max(v[1] - t_q0, 0.0))
            live[1].append((req, rec, n0))
        pending = still

    def scan(k: int) -> None:
        still = []
        for req, rec, n0 in live[k]:
            if rec.v_first is None and req.t_first_token:
                rec.v_first = v[k]
            if not req.done.is_set():
                still.append((req, rec, n0))
                continue
            if mode == "disagg" and k == 0 and stub_needs_handoff(req):
                tokens = list(req.tokens)
                steps = next(e.steps for e, r in
                             zip(events, records) if r is rec)
                entry = entry_for_stub(engines[0], req)
                payloads = export_prefix_pages(engines[0], tokens)
                wire = encode_handoff_pages(payloads)
                nbytes = sum(record_payload_bytes(r) for r in wire)
                planes = [decode_record(r) for r in wire]
                t_ready = (v[0] + handoff_latency_s
                           + len(planes) * handoff_page_cost_s)
                pending.append((t_ready, entry, planes, tokens, steps,
                                rec, req.n_sampled, nbytes, v[0]))
                continue
            rec.v_finish = v[k]
            rec.n_sampled = n0 + req.n_sampled
            rec.tokens_out = len(req.out)
            rec.error = req.error
        live[k] = still

    for _ in range(max_iters):
        if mode == "disagg":
            ingest_handoffs()
        for k in (0, 1):
            submit_arrivals(k)
        todo = [k for k in (0, 1) if outstanding(k)]
        if todo:
            k = min(todo, key=lambda p: v[p])
            eng = engines[k]
            s0, c0 = eng.stats.steps, eng.stats.prefill_chunks
            o0 = eng.stats.overrun_steps
            eng.step_many(eng.block_steps, quiet=True)
            # budget overruns cost extra step equivalents,
            # same charge as drive_engine — see the comment there
            v[k] += (step_cost_s * (eng.stats.steps - s0
                                    + eng.stats.overrun_steps - o0)
                     + chunk_cost * (eng.stats.prefill_chunks - c0))
            scan(k)
            continue
        # both pools idle: jump clocks to the next event, or stop
        jumps = []
        for k in (0, 1):
            if waiting[k]:
                jumps.append((waiting[k][0][0].t, k))
        if mode == "disagg" and pending:
            jumps.append((min(p[0] for p in pending), 1))
        if not jumps:
            if not (live[0] or live[1] or pending):
                break
            raise RuntimeError("drive_pools: live work but no pool has "
                               "anything to step — scheduler wedged")
        t_next, k = min(jumps)
        v[k] = max(v[k], t_next)
    else:
        raise RuntimeError(
            f"drive_pools: work still live after {max_iters} iterations")
    result = _finalize(records, policy, duration=max(max(v), 1e-9),
                       offered=trace.offered_rate)
    pools = []
    for k, eng in enumerate(engines):
        st = eng.stats
        pools.append({"steps": st.steps,
                      "prefill_chunks": st.prefill_chunks,
                      "pauses": st.pauses, "requeues": st.requeues,
                      "max_active": st.max_active,
                      "overrun_steps": st.overrun_steps,
                      "virtual_s": round(v[k], 4)})
    result.engine = {"mode": mode, "pools": pools}
    if mode == "disagg" and engines[1].allocator is not None:
        a = engines[1].allocator
        result.engine.update(pages_adopted=a.remote_adopted,
                             decode_prefix_hits=a.prefix_hits)
    return result


def drive_http(base_url: str, trace: Trace, policy,
               time_scale: float = 1.0, timeout: float = 120.0,
               stream: bool = True) -> LoadResult:
    """Replay ``trace`` against a live server on the WALL clock: one
    thread per request, fired at ``arrival * time_scale`` seconds after
    start. TTFT here is CLIENT-OBSERVED (first streamed NDJSON line —
    prompt echo included), the number a user's spinner sees; the server's
    own /metrics tracks the sampled-token anchor."""
    records = [RequestRecord(index=i, slo_class=e.slo_class,
                             arrival=e.t * time_scale)
               for i, e in enumerate(trace.events)]
    t0 = time.perf_counter()

    def one(i: int, e: TraceEvent, rec: RequestRecord):
        delay = e.t * time_scale - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        # traces carry raw token ids; the HTTP API takes text. Encode ids
        # as the chr(id - 3) string the test IdTokenizer round-trips —
        # real replays should record text prompts into the trace instead
        payload = {"prompt": "".join(chr(max(t - 3, 0) % 256)
                                     for t in e.tokens[1:]),
                   "steps": e.steps, "stream": bool(stream),
                   "class": e.slo_class}
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            f"{base_url}/generate", data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                if stream:
                    n_tok = 0
                    for line in r:
                        if not line.strip():
                            continue
                        obj = json.loads(line)
                        if "token" in obj:
                            n_tok += 1
                            if rec.v_first is None:
                                rec.v_first = time.perf_counter() - t0
                        if obj.get("done"):
                            rec.error = obj.get("error")
                    rec.tokens_out = rec.n_sampled = n_tok
                else:
                    out = json.loads(r.read())
                    rec.v_first = time.perf_counter() - t0
                    rec.tokens_out = rec.n_sampled = len(out["tokens"])
        except OSError as exc:
            rec.error = f"{type(exc).__name__}: {exc}"
        rec.v_finish = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(i, e, rec))
               for i, (e, rec) in enumerate(zip(trace.events, records))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    duration = time.perf_counter() - t0
    offered = trace.offered_rate / max(time_scale, 1e-9)
    return _finalize(records, policy, duration=duration, offered=offered)
