"""Deterministic fault injection + chaos drills for the continuous engine
(the JAX package's runtime/chaos.py).

The telemetry stack (obs/) can SHOW a leak or a wedged pool; this module
CAUSES one on purpose. Each drill here drives a fresh engine through one
failure mode the serving layer must absorb — pool exhaustion, transient
page starvation, oversized prompts, mid-stream client disconnects,
injected step-latency spikes, a profiler capture under load, KV-tier
churn, a torn or damaged journal, a SIGKILL mid-decode, a decode pool
killed mid-handoff, a hung dispatch, a weight stream cut mid-transfer —
and then asserts the post-drill invariants that define "absorbed":

* no leaked pages or slots: every allocated page's refcount is explained
  by a live slot mapping or a radix-tree node (paging.PagedAllocator.audit),
  the pool drains to free + tree-held == capacity, and every slot is free;
* metrics still scrapeable: the registry's Prometheus exposition parses;
* the engine still admits: a probe request runs to completion afterwards.

Injection is DETERMINISTIC — counters, not coin flips: "delay every Nth
dispatch", "deny the first N page allocations". A drill that fails
reproduces identically under the same config, which is what makes
``python -m distributed_llama_tpu_torch.tools.loadcheck`` a gate rather
than a flake source. The ``ChaosMonkey`` hooks are consulted by the
engine (pre-dispatch, page allocation, cancelled-retire release, the
mixed slice cut, the ledger charge and close, the tier demotion), by the
disaggregated handoff (page payloads, the traceparent) and by ``serve
--chaos`` for operator-driven drills against a live server.

The engines run on the card unless the factory (or ``device`` of the
drills with fixed specs) says otherwise; on the card the injected work
is host-side only (sleeps, refused allocations, dropped or zeroed
payloads, ledger arithmetic), so no hook runs inside a graph capture.

``leak_on_cancel``, ``drop_on_demote``, ``drop_page_in_flight`` and the
``corrupt-journal`` injection are the gate's MUTATION arms: each seeds a
fault one drill's audit must flag, proving the red path fires (loadcheck
exits 1 under each).
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class ChaosMonkey:
    """Deterministic fault-injection state, registered on an engine (the
    ``chaos=`` constructor knob) and/or a server. All knobs default OFF;
    counters record what actually fired so drills can assert injection
    happened.

    * ``step_delay_every``/``step_delay_s`` — sleep before every Nth
      device dispatch (a step-latency spike: a preempted host, a slow
      interconnect);
    * ``deny_pages`` — fail the first N page allocations (transient pool
      pressure without filling the pool);
    * ``leak_on_cancel`` — drop one page from every cancelled request's
      release (the seeded fault the invariant audit must catch);
    * ``drop_on_demote`` — KV tiering: every write-behind
      demotion discards its payload instead of storing it, so the tree
      records a host-tier page whose bytes exist nowhere — the seeded
      fault the three-tier audit (or a promotion of the lost page) must
      catch.
    """

    step_delay_every: int = 0
    step_delay_s: float = 0.0
    deny_pages: int = 0
    leak_on_cancel: bool = False
    drop_on_demote: bool = False
    # disaggregation: every handed-off page's payload is
    # replaced with zeros RE-FRAMED UNDER A VALID CRC — in-flight
    # corruption that slips past the channel's framing checks, which
    # only the bitwise stream gate can catch (the kill_mid_handoff
    # drill's mutation arm)
    drop_page_in_flight: bool = False
    # distributed tracing: strip the traceparent header at
    # the handoff seam — the decode pool's spans then cannot join the
    # prefill pool's, which tools/tracejoin.py must report as orphan
    # spans (the trace-propagation gate's mutation arm)
    drop_traceparent: bool = False
    # cost ledger: charge every decode/spec dispatch TWICE
    # into the per-request ledgers while the census counts it once —
    # breaks the Σ-ledger == engine-totals conservation equalities,
    # which tools/costcheck.py must catch (the accounting gate's
    # mutation arm)
    double_count_dispatch: bool = False
    # cost ledger: retire requests WITHOUT closing their
    # ledger — the zero-open-ledgers-after-drain check must flag the
    # orphans
    leak_ledger: bool = False
    # token-budget scheduler: the mixed dispatch's prefill
    # slice ignores the remaining budget and takes the whole staging
    # width — sum(span) then exceeds the budget, the virtual clock
    # charges the overrun as extra step time, and loadcheck's budget
    # gate must exit 1 (the budget sweep's mutation arm)
    overrun_budget: bool = False
    # injection counters (read by drills / surfaced in loadcheck rows)
    injected_delays: int = 0
    denied_allocs: int = 0
    leaked_pages: list = dataclasses.field(default_factory=list)
    dropped_demotions: int = 0
    dropped_pages: int = 0
    dropped_traceparents: int = 0
    double_counted: int = 0
    leaked_ledgers: int = 0
    overran_budgets: int = 0
    _dispatches: int = 0

    def on_dispatch(self) -> None:
        """Engine hook: called once per device dispatch, before launch."""
        self._dispatches += 1
        if (self.step_delay_every > 0 and self.step_delay_s > 0
                and self._dispatches % self.step_delay_every == 0):
            self.injected_delays += 1
            time.sleep(self.step_delay_s)

    def deny_page(self) -> bool:
        """Engine hook: True = this page allocation must fail (the engine
        then takes its real dry-pool path: pause, requeue, breaker)."""
        if self.denied_allocs < self.deny_pages:
            self.denied_allocs += 1
            return True
        return False

    def filter_release(self, pages: list) -> list:
        """Engine hook on a cancelled request's page release: with
        ``leak_on_cancel`` armed, steal one page so it is never released —
        the deliberate leak the audit must then report."""
        if self.leak_on_cancel and pages:
            self.leaked_pages.append(pages.pop())
        return pages

    def demote_drop(self) -> bool:
        """Allocator hook per write-behind demotion (KV tiering): True =
        discard this demotion's payload — the page leaves HBM but its
        bytes land in NO tier, the exactly-one-tier violation the
        three-tier audit must flag."""
        if self.drop_on_demote:
            self.dropped_demotions += 1
            return True
        return False

    def page_drop(self) -> bool:
        """Handoff-pack hook (runtime/disagg.encode_handoff_pages): True
        = zero this page's payload before framing — the seeded in-flight
        corruption the bitwise handoff gate must catch."""
        if self.drop_page_in_flight:
            self.dropped_pages += 1
            return True
        return False

    def trace_drop(self) -> bool:
        """Handoff-seam hook (runtime/disagg.DisaggPair.handoff, the
        server's POST /prefill): True = this hand-over loses its
        traceparent header — the trace-continuity break the tracejoin
        orphan gate must catch."""
        if self.drop_traceparent:
            self.dropped_traceparents += 1
            return True
        return False

    def dispatch_double(self) -> bool:
        """Ledger hook per decode/spec dispatch charge pass: True =
        multiply this dispatch's LEDGER charges by two while the census
        counts it once — the conservation break costcheck must catch."""
        if self.double_count_dispatch:
            self.double_counted += 1
            return True
        return False

    def ledger_leak(self) -> bool:
        """Retire hook: True = skip closing this request's ledger — the
        orphan the zero-open-after-drain check must flag."""
        if self.leak_ledger:
            self.leaked_ledgers += 1
            return True
        return False

    def budget_overrun(self) -> bool:
        """Mixed-dispatch hook per prefill-slice cut: True =
        the slice ignores the remaining token budget and takes the whole
        staging width — the seeded overrun the loadcheck budget gate's
        virtual clock must catch as inflated decode latency."""
        if self.overrun_budget:
            self.overran_budgets += 1
            return True
        return False

    def injection_summary(self) -> dict:
        return {"dispatches": self._dispatches,
                "injected_delays": self.injected_delays,
                "denied_allocs": self.denied_allocs,
                "leaked_pages": len(self.leaked_pages),
                "dropped_demotions": self.dropped_demotions,
                "dropped_pages": self.dropped_pages,
                "dropped_traceparents": self.dropped_traceparents,
                "double_counted": self.double_counted,
                "leaked_ledgers": self.leaked_ledgers,
                "overran_budgets": self.overran_budgets}

    @classmethod
    def parse(cls, text: str) -> "ChaosMonkey":
        """``key=value[,key=value...]`` (the --chaos CLI format): keys
        step_delay_every, step_delay_ms, deny_pages, leak_on_cancel."""
        kw: dict = {}
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"bad chaos knob {part!r}: want key=value")
            key, val = part.split("=", 1)
            key = key.strip()
            if key == "step_delay_ms":
                kw["step_delay_s"] = float(val) / 1e3
            elif key in ("step_delay_every", "deny_pages"):
                kw[key] = int(val)
            elif key in ("leak_on_cancel", "drop_on_demote",
                         "drop_page_in_flight", "drop_traceparent",
                         "double_count_dispatch", "leak_ledger",
                         "overrun_budget"):
                kw[key] = val.strip().lower() not in ("0", "false", "")
            else:
                raise ValueError(
                    f"unknown chaos knob {key!r} (have step_delay_every, "
                    f"step_delay_ms, deny_pages, leak_on_cancel, "
                    f"drop_on_demote, drop_page_in_flight, "
                    f"drop_traceparent, double_count_dispatch, "
                    f"leak_ledger, overrun_budget)")
        return cls(**kw)


def arm_mutations(chaos: "ChaosMonkey | None", leak_on_cancel: bool = False,
                  drop_on_demote: bool = False) -> "ChaosMonkey | None":
    """The load gate's engine-side injection: OR the mutation arms onto
    whatever monkey a drill brings (a fresh one when it brings none), so
    the arm fires under every drill's own faults. Unarmed, ``chaos`` comes
    back as it was."""
    if not (leak_on_cancel or drop_on_demote):
        return chaos
    if chaos is None:
        chaos = ChaosMonkey()
    chaos.leak_on_cancel = chaos.leak_on_cancel or leak_on_cancel
    chaos.drop_on_demote = chaos.drop_on_demote or drop_on_demote
    return chaos


@dataclasses.dataclass
class DrillResult:
    """One drill's verdict: ``passed`` is the gate bit; ``violations``
    lists every failed invariant (empty when passed); ``details`` carries
    the drill's observed counters for the loadcheck JSON row."""

    name: str
    passed: bool
    violations: list
    details: dict

    def to_json(self) -> dict:
        return {"name": self.name, "passed": self.passed,
                "violations": list(self.violations),
                "details": dict(self.details)}


def scrape_problems(registry) -> list[str]:
    """Parse the registry's Prometheus exposition; any unparseable sample
    line is a violation (a drill must not leave /metrics broken)."""
    if registry is None:
        return []
    try:
        text = registry.expose()
    except Exception as e:  # noqa: BLE001 - a raising scrape IS the finding
        return [f"/metrics exposition raised {type(e).__name__}: {e}"]
    problems = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        try:
            float(value)
        except ValueError:
            problems.append(f"unparseable exposition line: {line!r}")
        if not name:
            problems.append(f"sample line without a name: {line!r}")
    return problems


def check_invariants(eng, expect_drained: bool = True) -> list[str]:
    """The shared post-drill gate (module docstring): drained pool, page
    accounting clean, metrics scrapeable, engine still admitting."""
    problems: list[str] = []
    active = sum(not s.free for s in eng._pool)
    with eng._lock:
        queued = len(eng._queue)
    if expect_drained and (active or queued):
        problems.append(f"engine not drained: {active} active slots, "
                        f"{queued} queued requests")
    problems += [f"page audit: {p}" for p in eng.audit_pages()]
    if eng.allocator is not None:
        from .paging import TIER_HBM

        alloc = eng.allocator
        # spilled (host/disk) nodes hold no pool page — only HBM-tier
        # nodes count against the device pool (the tier audit inside
        # audit_pages covers the spilled copies)
        tree_held = sum(1 for n in alloc.tree.nodes()
                        if n.tier == TIER_HBM)
        slot_held = sum(len(s.pages) for s in eng._pool)
        # only decisive once slots drained: a shared-prefix page is held
        # by a slot AND the tree at once (the audit covers the live case)
        if (slot_held == 0
                and alloc.n_free + tree_held != alloc.n_pages):
            problems.append(
                f"page leak: {alloc.n_free} free + {tree_held} tree-held "
                f"!= {alloc.n_pages} pool pages with all slots drained")
    registry = eng._obs.registry if eng._obs is not None else None
    problems += scrape_problems(registry)
    # the engine must still admit and finish new work after the drill
    probe = [1, 7, 9]
    try:
        outs, _ = eng.run([probe], steps=3, quiet=True)
        if not outs[0]:
            problems.append("post-drill probe request produced no tokens")
    except Exception as e:  # noqa: BLE001 - a raising engine IS the finding
        problems.append(f"post-drill probe raised {type(e).__name__}: {e}")
    return problems


def _drain(eng, max_iters: int = 10_000) -> int:
    """Step until idle; returns iterations. Bounded — a scheduler that
    never drains is itself a drill failure (the caller sees active>0)."""
    it = 0
    while eng.step_many(eng.block_steps, quiet=True) and it < max_iters:
        it += 1
    return it


def _result(name: str, eng, chaos, extra_violations=(), **details):
    violations = list(extra_violations) + check_invariants(eng)
    if chaos is not None:
        details.update(chaos.injection_summary())
    return DrillResult(name=name, passed=not violations,
                       violations=violations, details=details)


def drill_pool_exhaustion(make_engine) -> DrillResult:
    """Oversubscribe the page pool: more concurrent demand than pages, so
    slots PAUSE for pages and admissions requeue — the engine must serve
    everything (or fail loudly via the deadlock breaker), then account
    for every page."""
    eng = make_engine()
    ps, pool = eng.page_size, eng.allocator.n_pages
    seq = eng.spec.seq_len
    # each request wants ~seq positions; enough requests that total demand
    # is several times the pool
    n_req = max(4, (3 * pool * ps) // seq)
    reqs = [[1] + [5 + (i * 3 + j) % 90 for j in range(3)]
            for i in range(n_req)]
    outs, stats = eng.run(reqs, steps=seq, quiet=True)
    empty = sum(1 for o in outs if not o)
    return _result("pool_exhaustion", eng, None,
                   extra_violations=(
                       [f"{empty} requests produced no output"]
                       if empty else []),
                   requests=n_req, pauses=stats.pauses,
                   tokens=stats.tokens)


def drill_transient_starvation(make_engine) -> DrillResult:
    """Deny the first N page allocations (ChaosMonkey.deny_pages): the
    engine's dry-pool paths (pause / head-of-queue requeue) must retry and
    complete every request once the denials run out."""
    chaos = ChaosMonkey(deny_pages=6)
    eng = make_engine(chaos=chaos)
    reqs = [[1] + [5 + (i * 7 + j) % 90 for j in range(4)]
            for i in range(4)]
    outs, stats = eng.run(reqs, steps=8, quiet=True)
    violations = []
    if chaos.denied_allocs != 6:
        violations.append(f"expected 6 denied allocations, got "
                          f"{chaos.denied_allocs}")
    if any(not o for o in outs):
        violations.append("a request starved permanently under transient "
                          "denial")
    return _result("transient_starvation", eng, chaos,
                   extra_violations=violations, pauses=stats.pauses)


def drill_oversized_prompt(make_engine) -> DrillResult:
    """Prompts longer than the position budget (and than seq_len): the
    engine must clamp to its budget, retire cleanly, and reject empty
    prompts with a clean error — never wedge or leak."""
    eng = make_engine()
    seq = eng.spec.seq_len
    huge = [1] + [5 + (j % 90) for j in range(2 * seq)]
    outs, _ = eng.run([huge, [1, 9, 9]], steps=seq, quiet=True)
    violations = []
    if len(outs[0]) > seq:
        violations.append(f"oversized prompt emitted {len(outs[0])} "
                          f"tokens past the {seq}-position budget")
    try:
        eng.run([[]], steps=4, quiet=True)
        violations.append("empty prompt was accepted")
    except ValueError:
        pass
    return _result("oversized_prompt", eng, None,
                   extra_violations=violations, echoed=len(outs[0]))


def drill_disconnect(make_engine) -> DrillResult:
    """Mid-flight client disconnects: cancel requests while they hold KV
    pages; every page must return to the pool (cancelled requests publish
    nothing to the radix tree), and kv_pages_free must round-trip."""
    from .continuous import Request

    eng = make_engine()
    free_before = eng.allocator.n_free
    seq = eng.spec.seq_len
    reqs = [Request(tokens=[1] + [5 + (i * 11 + j) % 90 for j in range(3)],
                    steps=seq) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    for _ in range(3):  # get them decoding (pages held)
        eng.step_many(eng.block_steps, quiet=True)
    held = sum(len(s.pages) for s in eng._pool)
    for r in reqs:
        eng.cancel(r)
    iters = _drain(eng)
    violations = []
    if held == 0:
        violations.append("drill never put pages at risk (no slot held "
                          "pages at cancel time)")
    if not all(r.done.is_set() for r in reqs):
        violations.append("a cancelled request never completed")
    free_after = eng.allocator.n_free
    if free_after != free_before:
        violations.append(
            f"kv_pages_free did not round-trip: {free_before} before, "
            f"{free_after} after cancel+drain")
    return _result("disconnect", eng, getattr(eng, "_chaos", None),
                   extra_violations=violations, pages_at_risk=held,
                   drain_iters=iters)


def drill_latency_spike(make_engine) -> DrillResult:
    """Inject step-latency spikes (sleep before every 2nd dispatch): the
    engine must finish the workload, and the step-duration histogram must
    have recorded through the spikes."""
    chaos = ChaosMonkey(step_delay_every=2, step_delay_s=0.002)
    eng = make_engine(chaos=chaos)
    reqs = [[1] + [5 + (i * 5 + j) % 90 for j in range(3)]
            for i in range(3)]
    outs, _ = eng.run(reqs, steps=6, quiet=True)
    violations = []
    if chaos.injected_delays == 0:
        violations.append("no latency spikes were injected")
    if any(not o for o in outs):
        violations.append("a request produced no output under spikes")
    if eng._obs is not None and eng._obs.step_duration.count == 0:
        violations.append("step-duration histogram recorded nothing")
    return _result("latency_spike", eng, chaos, extra_violations=violations)


def drill_tier_spill_storm(make_engine) -> DrillResult:
    """KV-tiering churn drill: a working set several times the
    HBM page pool cycles through twice under injected page-allocation
    denials, forcing deterministic demote (HBM→host→disk, write-behind)
    and promote (radix hit on a spilled prefix → async upload + PAUSE)
    churn — then the three-tier ``PagedAllocator.audit`` must close the
    ledger (every payload owned by exactly one tier, disk records
    CRC-verified by read-back, promotion/demotion counters consistent),
    the metrics exposition must still parse, and the engine must still
    admit. Pass 2 must also actually SAVE prefill tokens from spilled
    tiers — a hierarchy that spills but never promotes is not a cache."""
    import tempfile

    chaos = ChaosMonkey(deny_pages=4)
    disk_dir = tempfile.mkdtemp(prefix="dllama-chaos-tier-")
    eng = make_engine(chaos=chaos, kv_pages=8, kv_host_pages=6,
                      kv_disk_dir=disk_dir, slots=2)
    ps = eng.page_size
    n_prefix = 8  # 2 full pages each = 16 prefix pages vs the 8-page pool
    waves = []
    for tail in (3, 9):
        waves.append([[1] + [(7 * i + j) % 90 + 5 for j in range(2 * ps)]
                      + [tail + i] for i in range(n_prefix)])
    for wave in waves:
        eng.run(wave, steps=4 * ps, quiet=True)
    a = eng.allocator
    violations = []
    if sum(a.demotions.values()) == 0:
        violations.append("no demotions under a working set several "
                          "times the HBM pool")
    if sum(a.promotions.values()) == 0:
        violations.append("no promotions: spilled prefixes were never "
                          "raised back on re-match")
    spilled_saved = (a.tokens_saved_by_tier.get("host", 0)
                     + a.tokens_saved_by_tier.get("disk", 0))
    if spilled_saved == 0:
        violations.append("no prefill tokens saved from spilled tiers — "
                          "tiering rescued nothing from recompute")
    if chaos.denied_allocs == 0:
        violations.append("deny_pages pressure never fired")
    return _result("tier_spill_storm", eng, chaos,
                   extra_violations=violations,
                   demotions=dict(a.demotions),
                   promotions=dict(a.promotions),
                   tier_pages=a.tier_page_counts(),
                   prefill_saved_spilled=spilled_saved,
                   crc_drops=a.crc_drops)


def drill_profiler_under_load(make_engine) -> DrillResult:
    """Start a torch.profiler capture WHILE the engine serves: serving
    must not stall, and the capture must start and stop cleanly (the
    POST /profile contract, exercised under load instead of idle). Every
    CUDA graph the workload replays is captured before the profiler
    starts, as ``serve`` captures before its listener opens: a capture
    in the default global mode fails on another thread's CUDA call, and
    the profiler starts and stops on a thread of its own."""
    import tempfile

    from ..obs import profiler

    eng = make_engine()
    eng.capture_graphs()
    violations = []
    trace_dir = tempfile.mkdtemp(prefix="dllama-chaos-profile-")
    reqs = [[1] + [5 + (i * 7 + j) % 90 for j in range(3)]
            for i in range(3)]
    try:
        profiler.start_capture(trace_dir, seconds=0.2)
    except RuntimeError as e:
        violations.append(f"capture would not start: {e}")
    outs, _ = eng.run(reqs, steps=6, quiet=True)
    if any(not o for o in outs):
        violations.append("a request produced no output under capture")
    if not profiler.wait_capture(timeout=30.0):
        violations.append("profiler capture never stopped")
    return _result("profiler_under_load", eng, None,
                   extra_violations=violations, trace_dir=trace_dir)


# ------------------------------------------------------------- recovery
# Crash-safety drills. The kill-mid-decode drill spawns a REAL
# subprocess child, SIGKILLs it mid-decode, and proves the recovered
# continuation is bitwise the uninterrupted run — so the parent and the
# child must construct the SAME engine and requests from these fixed
# constants (a factory closure cannot cross the process boundary).

_RECOVERY_SPEC_KW = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                         n_kv_heads=2, vocab_size=128, seq_len=32)
# (tokens, steps, temperature, topp, seed): one greedy, one seeded-sampled
# — recovery must replay BOTH bitwise. Seeds chosen so neither stream hits
# BOS before its budget (the drill needs requests that are genuinely
# mid-decode at kill time).
_RECOVERY_REQS = (
    ([1, 9, 17, 25], 24, 0.0, 0.9, 501),
    ([1, 9, 17, 42], 24, 0.9, 0.9, 502),
)

# kill_mid_handoff's workload: prompts spanning >= 2 FULL
# pages (page_size 4) so the handoff genuinely ships pages the cut can
# interrupt; one greedy, one seeded-sampled — the handed-off stream must
# replay bitwise through the decode journal's coin cursor in both modes.
_HANDOFF_REQS = (
    ([1, 9, 17, 25, 31, 7, 3, 44, 11], 24, 0.0, 0.9, 501),
    ([1, 9, 17, 25, 31, 7, 3, 44, 5], 24, 0.9, 0.9, 502),
)


def _recovery_engine(journal=None, chaos=None, watchdog=None,
                     device="cuda"):
    """The recovery drills' fixed engine (the JAX package's recipe: the
    same spec, weights from the same seed, the same sampler config), on
    ``device``."""
    from ..models.spec import TransformerSpec
    from ..models.synth import synth_params
    from ..obs.metrics import Registry
    from .continuous import ContinuousEngine

    spec = TransformerSpec(**_RECOVERY_SPEC_KW)
    params = synth_params(spec, q40=False, seed=4, scale=0.3)
    return ContinuousEngine(spec, params, slots=2, temperature=0.8,
                            topp=0.9, seed=11, metrics=Registry(),
                            prefill_chunk=4, page_size=4, kv_pages=24,
                            chaos=chaos, journal=journal, watchdog=watchdog,
                            device=device)


def _submit_recovery_requests(eng) -> list:
    from .continuous import Request

    reqs = []
    for tokens, steps, temp, topp, seed in _RECOVERY_REQS:
        r = Request(tokens=list(tokens), steps=steps, temperature=temp,
                    topp=topp, seed=seed)
        eng.submit(r)
        reqs.append(r)
    return reqs


def recovery_child(journal_path: str, device: str = "cuda") -> None:
    """Subprocess body for the kill-mid-decode drill: serve the fixed
    recovery workload on ``device`` against a write-ahead journal
    (fsync=always: every record durable before the next dispatch) with an
    injected per-dispatch stall widening the kill window — then spin until
    the parent SIGKILLs us. Deliberately NEVER exits: finishing early
    would leave nothing to recover, which the parent reports as a drill
    failure. On the card it loads the kernels the parent's engines built
    (ops/_build's cache, under its lock)."""
    from .journal import RequestJournal

    journal = RequestJournal(journal_path, fsync="always")
    eng = _recovery_engine(
        journal=journal, chaos=ChaosMonkey(step_delay_every=1,
                                           step_delay_s=0.05),
        device=device)
    _submit_recovery_requests(eng)
    while True:
        eng.step_many(eng.block_steps, quiet=True)
        time.sleep(0.01)


def drill_kill_mid_decode(make_engine, inject=frozenset(),
                          device="cuda") -> DrillResult:
    """THE crash-safety acceptance drill: SIGKILL a journaling child
    process mid-decode, recover its journal into a fresh engine, and
    require the continued streams to be BITWISE identical to an
    uninterrupted reference run — greedy trivially, seeded-sampled via
    coin-cursor replay — with a clean page audit afterwards.

    ``inject={"corrupt-journal"}`` is the gate's mutation arm: a byte
    smashed MID-file (not the torn tail, which is legal damage) before
    recovery — loading must raise JournalCorruption, turning the drill
    red (loadcheck exits 1 under it).

    The child and the fixed-spec engines run on ``device``: the parent's
    deadline covers the child's CUDA start-up on the card."""
    import os
    import signal
    import subprocess
    import sys
    import tempfile

    from .journal import RequestJournal, load_journal

    violations: list = []
    tmp = tempfile.mkdtemp(prefix="dllama-chaos-recovery-")
    jpath = os.path.join(tmp, "requests.journal")
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.Popen(
        [sys.executable, "-c",
         "from distributed_llama_tpu_torch.runtime.chaos import "
         f"recovery_child; recovery_child({jpath!r}, {str(device)!r})"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    # wait until the journal PROVES both requests are mid-decode (>= 2
    # durable sampled tokens each, neither retired), then kill -9
    deadline = time.time() + 240.0
    ready = False
    while time.time() < deadline and child.poll() is None:
        try:
            entries = [e for e in load_journal(jpath) if e.status is None]
        except Exception:  # noqa: BLE001 - not created yet / torn reads
            entries = []
        if (len(entries) == len(_RECOVERY_REQS)
                and all(len(e.sampled) >= 2 for e in entries)):
            ready = True
            break
        time.sleep(0.005)
    if child.poll() is not None:
        err = (child.stderr.read() or b"").decode("utf-8", "replace")
        violations.append(f"child exited rc={child.returncode} before the "
                          f"kill: {err[-300:]}")
    else:
        if not ready:
            violations.append("journal never showed both requests "
                              "mid-decode within the window")
        child.send_signal(signal.SIGKILL)
    child.wait()
    if child.stderr is not None:
        child.stderr.close()

    if "corrupt-journal" in inject:
        # seeded mutation: damage a byte INSIDE the second record — deep
        # enough that torn-tail repair cannot explain it away
        with open(jpath, "rb") as fh:
            data = fh.read()
        pos = data.index(b"\n") + 2
        with open(jpath, "r+b") as fh:
            fh.seek(pos)
            fh.write(b"\xff")

    # uninterrupted reference: same engine recipe, same requests, no crash
    ref_eng = _recovery_engine(device=device)
    ref_reqs = _submit_recovery_requests(ref_eng)
    _drain(ref_eng)
    ref_outs = [r.out for r in ref_reqs]

    # recovery: reopen the journal (torn-tail repair happens here; any
    # deeper corruption raises and the gate goes red), re-admit, drain
    journal = RequestJournal(jpath)
    pre_entries = journal.incomplete()
    replayed = sum(len(e.sampled) for e in pre_entries)
    eng = _recovery_engine(journal=journal, device=device)
    n_recovered = eng.recover()
    with eng._lock:
        recovered = list(eng._queue)
    _drain(eng)
    if n_recovered != len(_RECOVERY_REQS):
        violations.append(f"expected {len(_RECOVERY_REQS)} journaled "
                          f"requests to recover, got {n_recovered}")
    for i, req in enumerate(recovered):
        if req.out != ref_outs[i]:
            violations.append(
                f"recovered stream {i} diverged from the uninterrupted "
                f"reference (first {min(len(req.out), len(ref_outs[i]))} "
                f"positions compared)")
    # trace continuity across the SIGKILL seam: the continued
    # life must keep the trace_id the killed process journaled, in a new
    # span linked 'recovers' — the cross-process join depends on it
    violations += _trace_continuity_violations(recovered, pre_entries,
                                               "recovers")
    if eng._spans is not None and recovered:
        links = [s for s in eng._spans.snapshot() if s.cat == "link"
                 and s.name == "recovers"]
        if len(links) != len(recovered):
            violations.append(
                f"expected {len(recovered)} 'recovers' link spans, "
                f"got {len(links)}")
    res = _result("kill_mid_decode", eng, None,
                  extra_violations=violations,
                  recovered=n_recovered, replayed_tokens=replayed)
    journal.close()
    return res


def _trace_continuity_violations(recovered, entries, link: str) -> list:
    """Shared seam check: each recovered/handed-off request
    must continue its journaled trace_id in a new span carrying the
    expected continuation link."""
    from ..obs import tracectx

    violations = []
    by_trace = {}
    for e in entries:
        if e.trace is None:
            violations.append(f"journaled request {e.rid} carries no "
                              f"trace header")
            continue
        try:
            by_trace[tracectx.parse_header(e.trace).trace_id] = e.rid
        except ValueError as exc:
            # recover() tolerates a damaged header (it never blocks
            # recovery); the drill must report it red, not crash
            violations.append(f"journaled request {e.rid} carries a "
                              f"malformed trace header: {exc}")
    for req in recovered:
        if req.trace is None:
            violations.append("recovered request carries no trace context")
        elif req.trace.trace_id not in by_trace:
            violations.append(
                f"recovered request's trace {req.trace.trace_id} matches "
                f"no journaled trace — the continuation re-minted instead "
                f"of continuing")
        elif req.trace.link != link:
            violations.append(
                f"recovered request's trace link is {req.trace.link!r}, "
                f"expected {link!r}")
    return violations


def drill_journal_wal(make_engine) -> DrillResult:
    """The write-ahead journal's durability contract under an engine:
    retired requests leave no live entries, compaction drops them from the
    file, a TORN TAIL (crash mid-append) repairs by truncation, and
    mid-file damage fails LOUDLY (JournalCorruption) instead of recovering
    untrusted state."""
    import os
    import tempfile

    from .journal import JournalCorruption, RequestJournal

    tmp = tempfile.mkdtemp(prefix="dllama-chaos-journal-")
    path = os.path.join(tmp, "requests.journal")
    journal = RequestJournal(path, fsync="batch", compact_every=2)
    eng = make_engine(journal=journal)
    reqs = [[1] + [5 + (i * 7 + j) % 90 for j in range(3)]
            for i in range(3)]
    outs, _ = eng.run(reqs, steps=6, quiet=True)
    journal.sync(force=True)
    violations = []
    if any(not o for o in outs):
        violations.append("a journaled request produced no output")
    if journal.incomplete():
        violations.append("retired requests still live in the journal")
    size_before = os.path.getsize(path)
    # torn tail: a crash mid-append leaves a partial line — reopening must
    # physically truncate it back to the last valid record
    with open(path, "ab") as fh:
        fh.write(b'{"t":"tok","id"')
    reopened = RequestJournal(path)
    reopened.close()
    if os.path.getsize(path) != size_before:
        violations.append(
            f"torn tail not repaired: {os.path.getsize(path)} bytes after "
            f"reopen, expected {size_before}")
    # mid-file damage: smash a byte of the FIRST record with more records
    # after it — this history cannot be trusted and must raise
    corrupt = os.path.join(tmp, "corrupt.journal")
    with open(corrupt, "wb") as fh:
        fh.write(b'{"t":"journal","v":1}\n'
                 b'{"t":"admit","id":0,"tokens":[1,5],"steps":4,'
                 b'"temperature":0.0,"topp":0.9,"seed":7,"slo":null,'
                 b'"cursor":0}\n'
                 b'{"t":"tok","id":0,"tok":9,"cursor":0}\n')
    with open(corrupt, "r+b") as fh:
        fh.seek(30)
        fh.write(b"\xff")
    try:
        RequestJournal(corrupt)
        violations.append("mid-file journal corruption was silently "
                          "accepted")
    except JournalCorruption:
        pass
    res = _result("journal_wal", eng, None, extra_violations=violations,
                  records=journal.records_total)
    journal.close()
    return res


def drill_hung_dispatch(make_engine) -> DrillResult:
    """A wedged device dispatch (injected stall far past the watchdog
    deadline): the StepWatchdog must TRIP and degrade health while the
    dispatch hangs, and — because this stall eventually resolves — the
    workload must still complete and health recover to serving."""
    from .supervisor import HealthMonitor, StepWatchdog

    health = HealthMonitor()
    health.to("serving")
    chaos = ChaosMonkey(step_delay_every=2, step_delay_s=0.25)
    watchdog = StepWatchdog(0.05, on_hang=lambda el: health.to("degraded"))
    eng = make_engine(chaos=chaos, watchdog=watchdog)
    try:
        reqs = [[1] + [5 + (i * 5 + j) % 90 for j in range(3)]
                for i in range(3)]
        outs, _ = eng.run(reqs, steps=6, quiet=True)
    finally:
        watchdog.close()
    violations = []
    if watchdog.trips == 0:
        violations.append("watchdog never tripped under an injected stall")
    if any(not o for o in outs):
        violations.append("a request produced no output under the stall")
    if health.state != "degraded":
        violations.append(f"the hang did not degrade health "
                          f"(state {health.state!r})")
    elif not health.to("serving"):
        violations.append("health would not recover to serving")
    return _result("hung_dispatch", eng, chaos,
                   extra_violations=violations, trips=watchdog.trips)


class _FlakyProxy:
    """Deterministic mid-transfer disconnect injector for the
    weight-stream drill: a TCP proxy relaying to an upstream WeightServer
    that hard-closes the client connection after relaying ``cut_after``
    upstream bytes — for the first ``cuts`` connections; later ones relay
    cleanly, so a resuming fetch always finishes. ``drops`` counts cuts
    actually injected."""

    def __init__(self, upstream_host: str, upstream_port: int,
                 cut_after: int, cuts: int = 2):
        import socket
        import threading

        self._socket, self._threading = socket, threading
        self.upstream = (upstream_host, upstream_port)
        self.cut_after = cut_after
        self.cuts = cuts
        self.drops = 0
        self._conns = 0
        self._lock = threading.Lock()
        self._listen = socket.socket()
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind(("127.0.0.1", 0))
        self._listen.listen(8)
        self.port = self._listen.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def _accept_loop(self):
        while True:
            try:
                client, _ = self._listen.accept()
            except OSError:
                return  # listener closed
            with self._lock:
                flaky = self._conns < self.cuts
                self._conns += 1
            self._threading.Thread(target=self._relay,
                                   args=(client, flaky),
                                   daemon=True).start()

    def _relay(self, client, flaky: bool):
        socket = self._socket
        try:
            up = socket.create_connection(self.upstream, timeout=30)
        except OSError:
            client.close()
            return

        def pump_requests():
            try:
                while True:
                    d = client.recv(65536)
                    if not d:
                        break
                    up.sendall(d)
            except OSError:
                pass

        self._threading.Thread(target=pump_requests, daemon=True).start()
        relayed = 0
        try:
            while True:
                d = up.recv(65536)
                if not d:
                    break
                if flaky and relayed + len(d) >= self.cut_after:
                    client.sendall(d[:self.cut_after - relayed])
                    with self._lock:
                        self.drops += 1
                    break  # the mid-transfer cut
                client.sendall(d)
                relayed += len(d)
        except OSError:
            pass
        finally:
            for sk in (client, up):
                # shutdown BEFORE close: the pump thread's in-flight recv
                # holds a kernel reference to the socket, so a bare close
                # would not emit the FIN until that recv returns — the
                # fetch client would stall on its own timeout instead of
                # seeing the disconnect immediately
                try:
                    sk.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    sk.close()
                except OSError:
                    pass

    def close(self):
        try:
            self._listen.close()
        except OSError:
            pass


def drill_weight_stream_disconnect(make_engine) -> DrillResult:
    """Mid-transfer disconnects + cache corruption on the weight stream:
    the slice fetch must RESUME through the range machinery (reconnect,
    re-fetch only the missing chunks) and end byte-identical to an
    uninterrupted reference fetch; then a corrupted resident byte must
    fail its sidecar CRC on the next fetch and be repaired."""
    import os
    import tempfile

    import numpy as np

    from ..io.loader import write_model
    from ..io.stream import WeightServer, fetch_model_slices
    from ..models.spec import TransformerSpec
    from ..ops.quants import FloatType

    tmp = tempfile.mkdtemp(prefix="dllama-chaos-stream-")
    spec = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=300, seq_len=32,
                           weights_float_type=FloatType.Q40)
    rng = np.random.default_rng(5)

    def t(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    tensors = {"tok_embedding": t(spec.vocab_size, spec.dim),
               "rms_att": 1 + t(spec.n_layers, spec.dim),
               "rms_ffn": 1 + t(spec.n_layers, spec.dim),
               "rms_final": 1 + t(spec.dim),
               "wcls": t(spec.vocab_size, spec.dim)}
    for name, shape in spec.layer_matmul_shapes():
        tensors[name] = t(spec.n_layers, *shape)
    src = os.path.join(tmp, "model.bin")
    write_model(src, spec, tensors)
    violations: list = []
    details: dict = {}
    server = WeightServer(src, host="127.0.0.1")
    proxy = _FlakyProxy("127.0.0.1", server.port, cut_after=64 << 10,
                        cuts=2)
    try:
        flaky_dst = os.path.join(tmp, "flaky", "model.bin")
        fetch_model_slices(f"127.0.0.1:{proxy.port}", flaky_dst,
                           FloatType.Q40, 1, {0}, quiet=True,
                           connect_window=20, max_resumes=8,
                           chunk_bytes=16 << 10)
        ref_dst = os.path.join(tmp, "ref", "model.bin")
        fetch_model_slices(f"127.0.0.1:{server.port}", ref_dst,
                           FloatType.Q40, 1, {0}, quiet=True)
        details["drops"] = proxy.drops
        if proxy.drops == 0:
            violations.append("the proxy never cut a connection — the "
                              "drill injected nothing")
        with open(flaky_dst, "rb") as a, open(ref_dst, "rb") as b:
            if a.read() != b.read():
                violations.append("resumed fetch is not byte-identical to "
                                  "the uninterrupted reference fetch")
        # corruption arm: flip one resident byte; the sidecar CRC must
        # catch it on the next fetch and re-fetch exactly that range
        size = os.path.getsize(src)
        with open(flaky_dst, "r+b") as fh:
            fh.seek(size // 2)
            byte = fh.read(1)
            fh.seek(size // 2)
            fh.write(bytes([byte[0] ^ 0xFF]))
        fetch_model_slices(f"127.0.0.1:{server.port}", flaky_dst,
                           FloatType.Q40, 1, {0}, quiet=True)
        with open(flaky_dst, "rb") as a, open(ref_dst, "rb") as b:
            if a.read() != b.read():
                violations.append("CRC verification did not repair the "
                                  "corrupted cache range")
    finally:
        proxy.close()
        server.close()
    return DrillResult(name="weight_stream_disconnect",
                       passed=not violations, violations=violations,
                       details=details)


def drill_kill_mid_handoff(make_engine, inject=frozenset(),
                           device="cuda") -> DrillResult:
    """THE disaggregation acceptance drill: kill the decode
    pool MID-PAGE-TRANSFER — after its journal durably holds the handoff
    admit (the durability point of the hand-over protocol), while page
    records are still crossing the TCP page channel — then restart it on
    the same journal. Recovery must re-admit the handed-off requests,
    the re-fetched pages must adopt, and the continued streams must be
    BITWISE the uninterrupted single-pool run (greedy AND seeded-sampled
    via the journal's coin cursor), with BOTH pools ending in a clean
    ``PagedAllocator.audit``.

    ``inject={"drop-page-in-flight"}`` is the gate's mutation arm: every
    shipped page's payload is zeroed and RE-FRAMED UNDER A VALID CRC —
    corruption the channel's framing cannot see — so the decode pool
    attends over junk and the bitwise gate must go red (loadcheck exits
    1 under it).

    The engines run on ``device``. The killed pool must be torn down
    without leaking: after its close (which waits for its in-flight
    copies) nothing may still reference it, and its page I/O holds no
    pinned bytes. On the card the details also carry the process's device
    allocation (all engines together) with the killed pool alive, after
    it is gone, and after the restarted pool is built; the bytes the
    kill released must cover what the fresh pool, built from the same
    recipe, allocates, or the drill is red."""
    import gc
    import os
    import tempfile
    import weakref

    from .disagg import DisaggPair, prefill_stub, stub_needs_handoff
    from .journal import RequestJournal

    from .continuous import Request

    violations: list = []
    chaos = ChaosMonkey(
        drop_page_in_flight="drop-page-in-flight" in inject)
    tmp = tempfile.mkdtemp(prefix="dllama-chaos-handoff-")
    jp_path = os.path.join(tmp, "prefill.journal")
    jd_path = os.path.join(tmp, "decode.journal")

    # uninterrupted single-pool reference: same recipe, same requests
    ref_eng = _recovery_engine(device=device)
    ref_reqs = []
    for tokens, steps, temp, topp, seed in _HANDOFF_REQS:
        r = Request(tokens=list(tokens), steps=steps, temperature=temp,
                    topp=topp, seed=seed)
        ref_eng.submit(r)
        ref_reqs.append(r)
    _drain(ref_eng)
    ref_outs = [r.out for r in ref_reqs]

    prefill = _recovery_engine(journal=RequestJournal(jp_path),
                               device=device)
    journal_a = RequestJournal(jd_path)
    decode_a = _disagg_decode_engine(journal_a, device=device)
    pair = DisaggPair(prefill, decode_a, channel_host="127.0.0.1",
                      chaos=chaos)
    stubs = []
    for tokens, steps, temp, topp, seed in _HANDOFF_REQS:
        stub, _ = prefill_stub(tokens, steps, temperature=temp,
                               topp=topp, seed=seed)
        prefill.submit(stub)
        stubs.append((stub, steps))
    _drain(prefill)
    cut = 0
    for stub, steps in stubs:
        if not stub_needs_handoff(stub):
            violations.append(f"stub {stub.index} retired without a "
                              f"continuation — nothing to hand off")
            continue
        try:
            # the decode admit lands in its journal, then the transfer is
            # CUT after one page — the kill window
            pair.handoff(stub, steps, cut_after=1)
            violations.append("page transfer was never cut mid-flight")
        except OSError:
            cut += 1
    # "kill" the decode pool: discard engine A entirely (its journal — the
    # durable admits — survives, exactly what a SIGKILL leaves behind;
    # the file handle closes so the restart reads a settled file)
    journal_a.sync(force=True)
    dev = decode_a.device
    memory = {"allocated_with_killed_pool": _allocated(dev)}
    io_a = decode_a.page_io
    decode_a.close()
    journal_a._fh.close()
    memory["killed_pool_pinned_after_close"] = (
        io_a.pinned_bytes if io_a is not None else 0)
    if memory["killed_pool_pinned_after_close"]:
        violations.append(
            f"killed decode pool's page I/O still holds "
            f"{memory['killed_pool_pinned_after_close']} pinned bytes "
            f"after close()")
    gone = weakref.ref(decode_a)
    pair.decode = None
    del decode_a, io_a
    gc.collect()
    if gone() is not None:
        violations.append("killed decode pool still referenced after the "
                          "kill: its device pool cannot be released")
    memory["allocated_after_kill"] = _allocated(dev)

    # restart: fresh decode pool on the same journal; recovery re-admits,
    # the channel still holds the unacked page records — re-fetch + adopt
    journal_b = RequestJournal(jd_path)
    pre_entries = journal_b.incomplete()
    decode_b = _disagg_decode_engine(journal_b, device=device)
    memory["allocated_with_restarted_pool"] = _allocated(dev)
    if memory["allocated_after_kill"] is not None:
        released = (memory["allocated_with_killed_pool"]
                    - memory["allocated_after_kill"])
        fresh = (memory["allocated_with_restarted_pool"]
                 - memory["allocated_after_kill"])
        memory.update(killed_pool_released=released,
                      restarted_pool_allocated=fresh,
                      restarted_pool_pinned=decode_b.page_io.pinned_bytes)
        if released < fresh:
            violations.append(
                f"the kill released {released} device bytes, less than "
                f"the {fresh} the restarted pool's fresh build allocates")
    n_rec = decode_b.recover()
    with decode_b._lock:
        recovered = list(decode_b._queue)
    from ..obs import tracectx as _tracectx

    for stub, steps in stubs:
        # the channel serves the handoff's trace identity NEXT TO its
        # pages (the TRACE command) — the restarted pool cross-checks it
        # against the trace the prefill stub opened before adopting
        # (fetch first: a completed fetch ACKs and retires the record)
        hdr = pair._client.trace(f"h{stub.index}")
        if hdr is None:
            violations.append(f"page channel lost the trace header for "
                              f"handoff h{stub.index}")
        elif _tracectx.parse_header(hdr).trace_id \
                != stub.trace.trace_id:
            violations.append(
                f"page channel trace for h{stub.index} does not match "
                f"the prefill stub's trace — the shipped pages would "
                f"join the wrong trace")
        records = pair._client.fetch(f"h{stub.index}")
        if records:
            decode_b.allocator.adopt_remote_pages(
                stub.tokens[:len(stub.tokens) - 1], records)
    _drain(decode_b)
    if n_rec != cut:
        violations.append(f"expected {cut} journaled handoffs to recover, "
                          f"got {n_rec}")
    for req in recovered:
        # recovered ids restart from the decode journal's next_id; map to
        # the reference by prompt (the original prompt is the replay
        # prefix)
        want = None
        for i, (tokens, *_rest) in enumerate(_HANDOFF_REQS):
            if list(req.tokens[:len(tokens)]) == list(tokens):
                want = ref_outs[i]
                break
        if want is None:
            violations.append("recovered request matches no reference "
                              "prompt")
        elif req.out != want:
            violations.append(
                "recovered handoff stream diverged from the uninterrupted "
                "single-pool reference (first "
                f"{min(len(req.out), len(want))} positions compared)")
    if decode_b.allocator.remote_adopted == 0 and not violations:
        violations.append("no pages were adopted on the restarted decode "
                          "pool — the re-fetch path never ran")
    # trace continuity across kill-mid-handoff: the decode
    # journal's admits carried the trace the PREFILL pool opened (same
    # trace_id, handoff-linked); the restarted pool's recovery must
    # continue it again (now 'recovers'-linked — the second seam)
    violations += _trace_continuity_violations(recovered, pre_entries,
                                               "recovers")
    for name, eng in (("prefill", prefill), ("decode", decode_b)):
        for p in eng.audit_pages():
            violations.append(f"{name} pool audit: {p}")
    details = {"handoffs_cut": cut, "recovered": n_rec,
               "pages_adopted": decode_b.allocator.remote_adopted,
               **chaos.injection_summary()}
    memory["allocated_after_recovery"] = _allocated(dev)
    if memory["allocated_after_recovery"] is not None:
        details["memory"] = memory
    pair._server.close()
    prefill.close()
    decode_b.close()
    journal_b.close()
    return DrillResult(name="kill_mid_handoff", passed=not violations,
                       violations=violations, details=details)


def _allocated(device) -> int | None:
    """``torch.cuda.memory_allocated`` on a card device after a
    synchronize: the whole process's tensors there, every engine's
    together. None off the card."""
    if device.type != "cuda":
        return None
    import torch

    torch.cuda.synchronize(device)
    return torch.cuda.memory_allocated(device)


def _disagg_decode_engine(journal=None, device="cuda"):
    """The kill-mid-handoff drill's decode pool: the recovery-drill
    engine recipe with the DCN ingestion knob on."""
    from ..models.spec import TransformerSpec
    from ..models.synth import synth_params
    from ..obs.metrics import Registry
    from .continuous import ContinuousEngine

    spec = TransformerSpec(**_RECOVERY_SPEC_KW)
    params = synth_params(spec, q40=False, seed=4, scale=0.3)
    return ContinuousEngine(spec, params, slots=2, temperature=0.8,
                            topp=0.9, seed=11, metrics=Registry(),
                            prefill_chunk=4, page_size=4, kv_pages=24,
                            journal=journal, remote_pages=True,
                            device=device)


# drill names that make up the recovery gate (loadcheck surfaces
# their verdicts as dedicated columns in its JSON row)
RECOVERY_DRILLS = ("journal_wal", "kill_mid_decode", "hung_dispatch",
                   "weight_stream_disconnect")

# drill names that make up the KV-tiering gate (same loadcheck
# coverage contract as RECOVERY_DRILLS: the baseline band file names them,
# and a full run that silently skips one fails the gate)
TIERING_DRILLS = ("tier_spill_storm",)

# ... and the disaggregation gate (kill the decode pool mid-page-
# transfer; recovery via its journal must be bitwise, both pools' audits
# clean) — same coverage contract, under "disagg_drills" in the baseline
DISAGG_DRILLS = ("kill_mid_handoff",)

DRILLS = (
    ("pool_exhaustion", drill_pool_exhaustion),
    ("transient_starvation", drill_transient_starvation),
    ("oversized_prompt", drill_oversized_prompt),
    ("disconnect", drill_disconnect),
    ("latency_spike", drill_latency_spike),
    ("profiler_under_load", drill_profiler_under_load),
    ("tier_spill_storm", drill_tier_spill_storm),
    ("journal_wal", drill_journal_wal),
    ("kill_mid_handoff", drill_kill_mid_handoff),
    ("kill_mid_decode", drill_kill_mid_decode),
    ("hung_dispatch", drill_hung_dispatch),
    ("weight_stream_disconnect", drill_weight_stream_disconnect),
)


def drill_kill_tp_follower(serve_cmd: list[str], timeout_s: float = 20.0,
                           payloads=None, env=None) -> DrillResult:
    """Serving over tp ranks: SIGKILL a follower mid-burst. ``serve_cmd``
    starts ``serve --tp N`` (its dispatches slowed, e.g. by ``--chaos
    step_delay_every=1,...``, so the burst is in flight). The drill passes
    when every client is answered and at least one with an error (rank 0
    failed the burst), and rank 0 is gone within ``timeout_s`` of the
    kill: with ``--supervise`` in ``serve_cmd`` the supervisor then
    respawned the whole group, which serves a request; without it the
    serve process (rank 0) exited non-zero."""
    import json
    import os
    import re
    import signal
    import subprocess
    import threading
    import urllib.request

    violations, details = [], {}
    supervised = "--supervise" in serve_cmd
    proc = subprocess.Popen(serve_cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True, env=env)
    lines = iter(proc.stdout)

    def group_up():
        """(port, follower pids) from the next group's banner lines."""
        port = None
        for line in lines:
            m = re.search(r"serving on http://[\d.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
            m = re.search(r"follower pids ([\d ]+)\)", line)
            if m:
                return port, [int(p) for p in m.group(1).split()]
        raise RuntimeError("the served group never came up")

    def post(port, payload, out, i, first=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=3 * timeout_s) as r:
                if payload.get("stream"):
                    rows = []
                    for ln in r:
                        rows.append(json.loads(ln))
                        if first is not None:
                            first.set()
                    out[i] = "error" in rows[-1]
                else:
                    out[i] = "error" in json.loads(r.read())
        except urllib.error.HTTPError:
            out[i] = True  # answered, with an error status
        except OSError as e:  # no answer at all
            out[i] = f"unanswered: {e}"

    try:
        port, pids = group_up()
        with open(f"/proc/{pids[0]}/stat") as fh:  # the follower's parent
            rank0 = int(fh.read().rsplit(")", 1)[1].split()[1])
        if not supervised and rank0 != proc.pid:
            violations.append(f"rank 0 is pid {rank0}, not serve's {proc.pid}")
        payloads = payloads or [
            {"prompt": "hello there", "steps": 48, "temperature": 0,
             "stream": i % 2 == 0} for i in range(4)]
        out = [None] * len(payloads)
        first = threading.Event()
        threads = [threading.Thread(target=post,
                                    args=(port, p, out, i, first))
                   for i, p in enumerate(payloads)]
        for t in threads:
            t.start()
        if not first.wait(3 * timeout_s):
            violations.append("the burst never started streaming")
        t0 = time.monotonic()
        os.kill(pids[0], signal.SIGKILL)
        while os.path.exists(f"/proc/{rank0}") and \
                time.monotonic() - t0 < 3 * timeout_s:
            with open(f"/proc/{rank0}/stat") as fh:
                if fh.read().rsplit(")", 1)[1].split()[0] == "Z":
                    break  # exited, not yet reaped
            time.sleep(0.05)
        details["rank0_exit_s"] = round(time.monotonic() - t0, 3)
        if details["rank0_exit_s"] >= timeout_s:
            violations.append(f"rank 0 outlived the kill by "
                              f"{details['rank0_exit_s']} s (timeout "
                              f"{timeout_s} s)")
        for t in threads:
            t.join(timeout_s)
        unanswered = [o for o in out if not isinstance(o, bool)]
        if unanswered:
            violations.append(f"clients left waiting: {unanswered}")
        details["failed_requests"] = sum(o is True for o in out)
        if not details["failed_requests"]:
            violations.append("no request of the burst failed")
        if supervised:
            port2, pids2 = group_up()  # the supervisor's respawn
            details["respawned"] = pids2 != pids
            got = [None]
            post(port2, {"prompt": "hi", "steps": 8, "temperature": 0}, got,
                 0)
            if got[0] is not False:
                violations.append(f"the respawned group did not serve: "
                                  f"{got}")
    except Exception as e:  # noqa: BLE001 - report, never crash the gate
        violations.append(f"drill raised {type(e).__name__}: {e}")
    finally:
        proc.send_signal(signal.SIGTERM)  # a no-op once rank 0 is gone
        try:
            rc = proc.wait(3 * timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
            violations.append("serve did not stop on SIGTERM")
    details["supervisor_rc" if supervised else "rc"] = rc
    if not supervised and rc == 0:
        violations.append("rank 0 exited 0 after a follower died")
    return DrillResult(name="kill_tp_follower", passed=not violations,
                       violations=violations, details=details)


def run_drills(make_engine, which=None, inject=None,
               device="cuda") -> list[DrillResult]:
    """Run the drill suite against fresh engines from ``make_engine``
    (a callable accepting ``chaos=`` plus engine-constructor overrides;
    every drill gets its own engine — faults must not bleed). ``which``
    filters by drill name; ``inject`` names seeded mutations forwarded to
    drills that accept them (the gate's self-test arms); ``device`` is
    where the drills with fixed specs build their engines (the recovery
    child included). A drill that RAISES is converted into a failed
    result — the gate must report, not crash."""
    import inspect

    inject = frozenset(inject or ())
    results = []
    for name, fn in DRILLS:
        if which is not None and name not in which:
            continue
        params = inspect.signature(fn).parameters
        kwargs = {k: v for k, v in (("inject", inject), ("device", device))
                  if k in params}
        try:
            results.append(fn(make_engine, **kwargs))
        except Exception as e:  # noqa: BLE001 - report, never crash the gate
            results.append(DrillResult(
                name=name, passed=False,
                violations=[f"drill raised {type(e).__name__}: {e}"],
                details={}))
    return results


def render_drill_table(results) -> str:
    """The human verdict table (tracecheck-style)."""
    lines = [f"{'drill':<24} {'verdict':<8} detail"]
    for r in results:
        detail = ("; ".join(r.violations) if r.violations
                  else ", ".join(f"{k}={v}" for k, v in
                                 sorted(r.details.items())
                                 if not isinstance(v, str)))
        lines.append(f"{r.name:<24} {'OK' if r.passed else 'FAIL':<8} "
                     f"{detail}")
    return "\n".join(lines)
