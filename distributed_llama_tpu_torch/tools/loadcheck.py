"""loadcheck: offered-load sweep + chaos drills, gated (the port's copy of
the repository's tools/loadcheck.py, with its flags, rows and exit codes).

Builds a small synthetic-weight engine (the JAX tool's spec and seed) on
``--device`` (default the card), replays a seeded loadgen workload at
each point of an offered-load sweep up to saturation, and reports the
curve serving systems are judged by: GOODPUT (sampled tokens of SLO-met
requests per time unit) and per-class attainment vs offered load. Then
runs the full runtime/chaos.py drill suite — every drill asserts the
post-fault invariants (no leaked pages/slots, scrapeable metrics, engine
still admitting).

The sweep runs on loadgen's VIRTUAL clock (one device step = one time
unit), so the curve is a function of the scheduler and the token streams
only: the port falls in the band of the checked-in baseline
(loadcheck_baseline.json beside this file, a byte-equal copy of
tools/loadcheck_baseline.json) without a baseline of its own. Exit 0 =
curve within band and every drill passed; 1 = regression or drill
failure (or no GPU for ``--device cuda``); 2 = usage/baseline error.

The final stdout line is one JSON row stamped with the port's
``utils/fingerprint.run_stamp`` plus the engine config, so rows stay
joinable.

``--inject leak-on-cancel`` arms the seeded page leak on every cancelled
release (the disconnect drill must go red); ``corrupt-journal`` smashes a
byte mid-file in the kill-mid-decode drill's journal before recovery
(JournalCorruption, red); ``drop-on-demote`` discards every write-behind
demotion's payload (the spill-storm drill, red); ``drop-page-in-flight``
zeroes every shipped page under a VALID CRC (kill_mid_handoff's bitwise
gate, red); ``overrun-budget`` (with ``--budget``) packs mixed prefill
slices past the token budget (the budget gate, red).

The recovery, tiering and disaggregation drills get verdict columns in
the JSON row, and the baseline names them: a full drill run that skips
one fails the gate. ``--two-pool`` replays a mixed interactive/batch
trace against two colocated engines and against a prefill pool + decode
pool at equal simulated hardware, gating on disaggregation beating
colocated interactive attainment; ``--budget`` compares token-budget
mixed dispatch against separate dispatch.

Usage:
  python -m distributed_llama_tpu_torch.tools.loadcheck [--sweep R1,...]
      [--requests N] [--seed N] [--slots N] [--page-size P] [--kv-pages N]
      [--spec-k K] [--block-steps K] [--baseline PATH]
      [--sweep-only | --drills-only] [--drills NAMES]
      [--two-pool] [--two-pool-rate R] [--budget T1,T2,...]
      [--inject leak-on-cancel|corrupt-journal|drop-on-demote|
               drop-page-in-flight|overrun-budget]
      [--trace-out DIR] [--json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "loadcheck_baseline.json")

# the sweep's model: the test-suite small transformer shape, enlarged to
# seq 32 so paging has room to matter
SPEC_KW = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=4, n_kv_heads=2,
               vocab_size=128, seq_len=32)


def _policy():
    """The gate's SLO policy, in VIRTUAL seconds (1.0 = one device step):
    interactive wants a first token within 12 steps of ARRIVAL (queue
    wait counts — that is the point) and a mean token latency under 3
    steps; batch tolerates 10x. Chosen so the default sweep's low rates
    attain ~1.0 and the top rates visibly break — the curve must show
    the saturation knee, or it gates nothing."""
    from ..obs.slo import SLOClass, SLOPolicy

    return SLOPolicy((SLOClass("interactive", 12.0, 3.0),
                      SLOClass("batch", 120.0, 30.0)))


def _load_spec(rate: float, args):
    from .loadgen import LoadSpec

    return LoadSpec(
        rate=rate, n_requests=args.requests, arrivals=args.arrivals,
        prompt_lens=(4, 8, 12), out_lens=(4, 8),
        shared_prefix_rate=0.5, shared_prefix_len=2 * args.page_size,
        n_shared_prefixes=2, classes=("interactive", "batch"),
        class_weights=(3, 1), vocab=SPEC_KW["vocab_size"],
        seq_len=SPEC_KW["seq_len"])


def build_engine_factory(args, inject_leak: bool = False,
                         inject_demote_drop: bool = False):
    """A fresh-engine factory (the chaos drill contract: every drill gets
    its own engine; faults must not bleed). With ``inject_leak`` the
    factory arms leak_on_cancel on whatever monkey the drill brings —
    the mutation the CI gate proves catchable; ``inject_demote_drop``
    arms the KV-tiering twin (drop_on_demote — the spill-storm drill's
    three-tier audit must flag the payload that landed in no tier). The
    engines are built on ``args.device``; the weights are placed there
    once and shared."""
    from ..models.llama import params_to_device
    from ..models.spec import TransformerSpec
    from ..models.synth import synth_params
    from ..obs.metrics import Registry
    from ..runtime.chaos import arm_mutations
    from ..runtime.continuous import ContinuousEngine

    spec = TransformerSpec(**SPEC_KW)
    params = params_to_device(synth_params(spec, q40=False, seed=4,
                                           scale=0.3), args.device)

    def make_engine(chaos=None, **overrides):
        chaos = arm_mutations(chaos, inject_leak, inject_demote_drop)
        kw = dict(slots=args.slots, temperature=0.0, topp=0.9,
                  seed=args.seed, metrics=Registry(),
                  prefill_chunk=args.page_size,
                  block_steps=args.block_steps,
                  page_size=args.page_size, kv_pages=args.kv_pages,
                  spec_k=args.spec_k, device=args.device)
        kw.update(overrides)
        return ContinuousEngine(spec, params, chaos=chaos, **kw)

    return make_engine


def _two_pool_policy():
    """The two-pool gate's SLO policy: the interactive TOKEN budget is
    the discriminating one — 1.75 virtual steps/token sits between the
    decode pool's clean cadence (~1.0-1.3: no long prefill ever runs
    there) and a colocated engine's cadence under batch-prefill stalls
    (a 7-chunk admission freezes every in-flight decode for 7 steps).
    TTFT stays at the main gate's 12."""
    from ..obs.slo import SLOClass, SLOPolicy

    return SLOPolicy((SLOClass("interactive", 12.0, 1.75),
                      SLOClass("batch", 120.0, 30.0)))


def _two_pool_spec(args):
    """The two-pool comparison's MIXED trace: short interactive prompts
    with LONG outputs (chat — decode-heavy, TPOT-sensitive), long batch
    prompts (28 positions = 7 prefill chunks: the interference source),
    some shared-prefix traffic so the decode pool's radix publish
    matters."""
    from .loadgen import LoadSpec

    return LoadSpec(
        rate=args.two_pool_rate, n_requests=args.requests,
        arrivals=args.arrivals, prompt_lens=(4, 6),
        out_lens=(12, 16), shared_prefix_rate=0.25,
        shared_prefix_len=args.page_size, n_shared_prefixes=2,
        classes=("interactive", "batch"), class_weights=(4, 1),
        class_prompt_lens=((4, 6), (28,)),
        vocab=SPEC_KW["vocab_size"], seq_len=SPEC_KW["seq_len"])


def run_two_pool(args, make_engine) -> tuple[dict, list[str]]:
    """Colocated vs disaggregated at EQUAL simulated hardware: the same
    mixed trace replayed against (a) two full engines,
    arrivals round-robin, and (b) a prefill pool (SLO-priority admission
    + chunk-boundary preemption) handing off to a decode pool over the
    wire codec with modeled DCN latency. Both run the same virtual cost
    model (1 step = 1, 1 prefill chunk = 1). The gate: disaggregation
    must BEAT the colocated baseline on interactive-class attainment —
    the TTFT/TPOT interference win is the topology's whole claim."""
    from ..runtime.disagg import make_priority_hold
    from .loadgen import drive_pools, generate_trace

    policy = _two_pool_policy()
    trace = generate_trace(_two_pool_spec(args), args.seed)
    # per-pool resources: 8 slots and a NON-oversubscribed page pool
    # (slots x max pages) per pool, IDENTICAL across both topologies
    # (equal simulated hardware) — page thrash is the sweep's gate, not
    # this one's
    slots = 2 * args.slots
    pages = slots * (SPEC_KW["seq_len"] // args.page_size)
    coloc = [make_engine(slo=policy, slo_priority=True, slots=slots,
                         kv_pages=pages)
             for _ in range(2)]
    res_c = drive_pools(coloc, trace, policy, mode="colocated",
                        step_cost_s=args.step_cost,
                        chunk_cost_s=args.step_cost)
    prefill = make_engine(slo=policy, slo_priority=True, slots=slots,
                          kv_pages=pages)
    prefill.prefill_hold = make_priority_hold(prefill, policy)
    decode = make_engine(remote_pages=True, slots=slots, kv_pages=pages)
    res_d = drive_pools([prefill, decode], trace, policy, mode="disagg",
                        step_cost_s=args.step_cost,
                        chunk_cost_s=args.step_cost,
                        handoff_latency_s=args.step_cost,
                        handoff_page_cost_s=args.step_cost / 4)
    failures = []
    att_c = res_c.attainment.get("interactive", 1.0)
    att_d = res_d.attainment.get("interactive", 1.0)
    if not att_d > att_c:
        failures.append(
            f"two-pool gate: disaggregated interactive attainment "
            f"{att_d:.4f} does not beat colocated {att_c:.4f} at equal "
            f"simulated hardware (rate {args.two_pool_rate})")
    for name, eng in (("prefill", prefill), ("decode", decode),
                      ("colocated-0", coloc[0]),
                      ("colocated-1", coloc[1])):
        for p in eng.audit_pages():
            failures.append(f"two-pool {name} audit: {p}")
    row = {"rate": args.two_pool_rate,
           "colocated": res_c.to_json(), "disagg": res_d.to_json(),
           "interactive_attainment": {"colocated": att_c, "disagg": att_d}}
    if not args.json:
        print(f"two-pool rate {args.two_pool_rate:g}: interactive "
              f"attainment colocated {att_c:.2f} -> disagg {att_d:.2f}; "
              f"goodput {res_c.goodput_tps:.3f} -> "
              f"{res_d.goodput_tps:.3f} tok/step")
    return row, failures


def run_budget(args, make_engine) -> tuple[dict, list[str]]:
    """Token-budget colocated vs separate-dispatch colocated at EQUAL
    simulated hardware: the two-pool comparison's mixed trace
    replayed against (a) two plain colocated engines (decode dispatches
    + chunk-prefill dispatches — every 28-position batch admission
    freezes in-flight decodes for 7 chunk dispatches) and (b) the same
    two engines with ``dispatch_tokens=budget``: every dispatch carries
    all active decode rows plus one prefill slice cut to the remaining
    budget, so prefill rides the dispatches decode was already paying
    for. Same virtual cost model (1 fused dispatch = 1 step, 1 chunk
    dispatch = 1 step, budget overruns charge their extra step
    equivalents — loadgen.drive_pools). The gate: the best budget point
    must close most of the interference gap — interactive attainment
    >= 0.90 — WITHOUT giving up goodput vs the separate-dispatch
    baseline. ``--inject overrun-budget`` arms the chaos mutation that
    packs slices past the budget; overruns are a hard gate (any
    overrun voids the 1-dispatch-per-step cost model) on top of the
    extra virtual-clock charge, so the mutation must go red (exit 1) —
    proving the budget is load-bearing and not a free knob."""
    from ..runtime.chaos import ChaosMonkey
    from .loadgen import drive_pools, generate_trace

    policy = _two_pool_policy()
    trace = generate_trace(_two_pool_spec(args), args.seed)
    slots = 2 * args.slots
    pages = slots * (SPEC_KW["seq_len"] // args.page_size)
    failures: list[str] = []

    base = [make_engine(slo=policy, slo_priority=True, slots=slots,
                        kv_pages=pages) for _ in range(2)]
    res_base = drive_pools(base, trace, policy, mode="colocated",
                           step_cost_s=args.step_cost,
                           chunk_cost_s=args.step_cost)
    att_base = res_base.attainment.get("interactive", 1.0)
    for i, eng in enumerate(base):
        for problem in eng.audit_pages():
            failures.append(f"budget baseline-{i} audit: {problem}")

    points = []
    best = None
    for budget in args.budget:
        engines = []
        for _ in range(2):
            chaos = (ChaosMonkey(overrun_budget=True)
                     if args.inject == "overrun-budget" else None)
            engines.append(make_engine(chaos=chaos, slo=policy,
                                       slo_priority=True, slots=slots,
                                       kv_pages=pages,
                                       dispatch_tokens=budget))
        res_b = drive_pools(engines, trace, policy, mode="colocated",
                            step_cost_s=args.step_cost,
                            chunk_cost_s=args.step_cost)
        att = res_b.attainment.get("interactive", 1.0)
        overruns = sum(e.stats.overrun_steps for e in engines)
        for i, eng in enumerate(engines):
            for problem in eng.audit_pages():
                failures.append(f"budget={budget} engine-{i} audit: "
                                f"{problem}")
        if overruns:
            failures.append(
                f"budget={budget}: {overruns} overrun step(s) — the "
                f"scheduler packed dispatches past their token budget, "
                f"so the single-dispatch cost model (and every "
                f"attainment number above) is void")
        point = {"budget": budget, "interactive_attainment": att,
                 "goodput_tps": res_b.goodput_tps,
                 "overrun_steps": overruns, "result": res_b.to_json()}
        points.append(point)
        if best is None or att > best["interactive_attainment"]:
            best = point
        if not args.json:
            print(f"budget {budget:<3d}: interactive attainment "
                  f"{att_base:.2f} -> {att:.2f}; goodput "
                  f"{res_base.goodput_tps:.3f} -> "
                  f"{res_b.goodput_tps:.3f} tok/step; overruns "
                  f"{overruns}")

    if best["interactive_attainment"] < 0.90:
        failures.append(
            f"budget gate: best interactive attainment "
            f"{best['interactive_attainment']:.4f} (budget "
            f"{best['budget']}) below the 0.90 floor — token-budget "
            f"scheduling is not closing the prefill-interference gap "
            f"(separate-dispatch baseline {att_base:.4f})")
    elif best["goodput_tps"] < res_base.goodput_tps:
        failures.append(
            f"budget gate: best point (budget {best['budget']}) trades "
            f"goodput away — {best['goodput_tps']:.4f} tok/step below "
            f"the separate-dispatch baseline "
            f"{res_base.goodput_tps:.4f}")
    row = {"rate": args.two_pool_rate, "budgets": list(args.budget),
           "baseline": {"interactive_attainment": att_base,
                        "goodput_tps": res_base.goodput_tps,
                        "result": res_base.to_json()},
           "points": points,
           "best": {"budget": best["budget"],
                    "interactive_attainment":
                        best["interactive_attainment"],
                    "goodput_tps": best["goodput_tps"]}}
    return row, failures


class _Feed:
    """The watchtower feed of one sweep point (the repository's
    tools/watchcheck.py ``_Feed``): cumulative verdict and goodput
    counters (the tower's ring diffs them back to deltas) plus the tick
    pump that snapshots the engine into the tower."""

    def __init__(self, tower, replica="sim-0"):
        self.tower = tower
        self.replica = replica
        self.verdicts = {"met": 0, "violated": 0, "failed": 0}
        self.goodput = 0

    def tick(self, eng):
        from ..obs.watch import sample_from_engine

        self.tower.observe(self.replica, sample_from_engine(
            eng, verdicts=self.verdicts, goodput_tokens=self.goodput,
            handoff_failed=0, handoff_total=0, recoveries=0))

    def settle(self, rec, policy):
        """Incremental verdict accounting for a finished loadgen record:
        ``loadgen._finalize``'s formulas, evaluated at finish time so the
        tower sees verdict deltas."""
        ttft = (rec.v_first - rec.arrival
                if rec.v_first is not None else None)
        per_token = None
        if (rec.n_sampled > 0 and rec.v_first is not None
                and rec.v_finish is not None):
            per_token = (rec.v_finish - rec.v_first) / rec.n_sampled
        c = policy.resolve(rec.slo_class)
        verdict = c.evaluate(ttft, per_token, failed=rec.error is not None)
        self.verdicts[verdict] += 1
        if verdict == "met":
            self.goodput += rec.n_sampled


def run_sweep(args, make_engine) -> list[dict]:
    """One LoadResult row per offered rate (fresh engine + fresh trace
    per point, same seed — points differ only in arrival rate). Each
    point also runs its own watchtower fed per scheduler
    tick; the point's ``watch`` verdict — quiet or firing, with the
    per-kind counts — rides the row and is pinned by the baseline band
    file, so a detector that starts paging on a clean low-rate point
    (or goes blind at saturation) is a gate failure, not a surprise."""
    from ..obs.watch import Watchtower
    from .loadgen import drive_engine, generate_trace, save_trace

    policy = _policy()
    rows = []
    for rate in args.sweep:
        trace = generate_trace(_load_spec(rate, args), args.seed)
        if args.trace_out:
            os.makedirs(args.trace_out, exist_ok=True)
            save_trace(trace, os.path.join(
                args.trace_out, f"trace_rate{rate:g}.json"))
        eng = make_engine()
        tower = Watchtower(spans=None)
        feed = _Feed(tower, replica=f"rate-{rate:g}")

        def on_tick(v, finished, feed=feed, eng=eng):
            for rec in finished:
                feed.settle(rec, policy)
            feed.tick(eng)

        res = drive_engine(eng, trace, policy,
                           step_cost_s=args.step_cost, on_tick=on_tick)
        watch = {
            "verdict": "quiet" if not tower.incidents_total else "firing",
            "incidents_total": tower.incidents_total,
            "incidents": {k: n for k, n in sorted(tower.by_kind().items())
                          if n},
        }
        row = {"rate": rate, **res.to_json(), "watch": watch}
        rows.append(row)
        if not args.json:
            att = " ".join(f"{c}={a:.2f}"
                           for c, a in res.attainment.items())
            print(f"rate {rate:<6g} goodput {res.goodput_tps:7.3f} "
                  f"tok/step  attainment {att}  pauses "
                  f"{res.engine.get('pauses', 0)}  watch "
                  f"{watch['verdict']}")
    return rows


# where the band is written: the reference tool, whose output the port's
# copy of the file must stay byte-equal to
_REWRITE = ("python tools/loadcheck.py --write-baseline, then copy "
            "tools/loadcheck_baseline.json over "
            "distributed_llama_tpu_torch/tools/loadcheck_baseline.json")


def check_baseline(rows: list[dict], path: str) -> tuple[list[str],
                                                           dict | None]:
    """Hold each sweep point's goodput to the checked-in band. Returns
    (failures, baseline_doc). The port writes no band: the file is a
    byte-equal copy of the repository's tools/loadcheck_baseline.json
    (the virtual clock makes the curve the scheduler's, not the
    framework's), regenerated by the reference tool (``_REWRITE``)."""
    if not os.path.exists(path):
        return [f"baseline {path} missing ({_REWRITE})"], None
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    by_rate = {p["rate"]: p for p in doc.get("points", [])}
    failures = []
    for row in rows:
        point = by_rate.get(row["rate"])
        if point is None:
            failures.append(f"rate {row['rate']}: no baseline point "
                            f"(after changing the sweep: {_REWRITE})")
            continue
        lo, hi = point["band"]
        got = row["goodput_tps"]
        if got < lo:
            failures.append(
                f"rate {row['rate']}: goodput {got:.3f} below the "
                f"baseline band [{lo:.3f}, {hi:.3f}] — a goodput "
                f"regression")
        elif got > hi:
            # better-than-band is progress, not a failure; say so loudly
            # so the band gets re-pinned
            print(f"loadcheck: rate {row['rate']}: goodput {got:.3f} "
                  f"ABOVE band [{lo:.3f}, {hi:.3f}] — consider "
                  f"{_REWRITE}", file=sys.stderr)
        # watchtower verdict pin. Tolerate a baseline from
        # before the column existed — absent means unpinned, not quiet.
        want_watch = point.get("watch")
        got_watch = row.get("watch", {}).get("verdict")
        if want_watch is not None and got_watch != want_watch:
            failures.append(
                f"rate {row['rate']}: watchtower verdict {got_watch!r}, "
                f"baseline pins {want_watch!r} — detector behavior "
                f"drifted on this point")
    return failures, doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="loadcheck",
        description="offered-load sweep (goodput vs SLO) + chaos drills "
                    "with a baseline-band CI gate")
    ap.add_argument("--sweep", default="0.05,0.1,0.2,0.4,0.8,1.6",
                    help="offered rates (requests per virtual step), "
                         "comma-separated; >= 4 points for a curve")
    ap.add_argument("--requests", type=int, default=24,
                    help="requests per sweep point")
    ap.add_argument("--arrivals", default="bursty",
                    choices=("poisson", "bursty"))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=4)
    ap.add_argument("--kv-pages", type=int, default=20,
                    help="pool pages (default oversubscribes 4 slots x 8 "
                         "max pages = 32 down to 20 so admission pressure "
                         "is part of the gate)")
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--block-steps", type=int, default=1)
    ap.add_argument("--step-cost", type=float, default=1.0,
                    help="virtual seconds per device step")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--sweep-only", action="store_true")
    ap.add_argument("--drills-only", action="store_true")
    ap.add_argument("--drills", default=None, metavar="NAMES",
                    help="run only these drills (comma-separated names "
                         "from runtime/chaos.DRILLS)")
    ap.add_argument("--inject", default=None,
                    choices=("leak-on-cancel", "corrupt-journal",
                             "drop-on-demote", "drop-page-in-flight",
                             "overrun-budget"),
                    help="arm a seeded mutation; the drill suite MUST "
                         "go red (the CI gate's self-test): "
                         "leak-on-cancel leaks a page per cancelled "
                         "release (disconnect drill), corrupt-journal "
                         "smashes a mid-file journal byte before "
                         "recovery (kill_mid_decode drill), "
                         "drop-on-demote discards every KV-tier "
                         "demotion's payload (tier_spill_storm drill), "
                         "drop-page-in-flight zeroes every handed-off "
                         "page under a valid CRC (kill_mid_handoff "
                         "drill — only the bitwise gate can catch it), "
                         "overrun-budget packs mixed prefill slices "
                         "past the token budget (--budget comparison "
                         "must go red: the overrun step charge drags "
                         "attainment below the gate)")
    ap.add_argument("--two-pool", action="store_true",
                    help="run the colocated-vs-disaggregated comparison "
                         "on the mixed interactive/batch "
                         "trace; gates on disagg beating colocated "
                         "interactive attainment at equal simulated "
                         "hardware")
    ap.add_argument("--two-pool-rate", type=float, default=0.25,
                    help="offered rate of the two-pool comparison trace")
    ap.add_argument("--budget", default=None, metavar="T1,T2,...",
                    help="run the token-budget comparison: "
                         "the two-pool mixed trace against colocated "
                         "engines with --dispatch-tokens at each budget "
                         "vs separate-dispatch colocated at equal "
                         "simulated hardware; gates on the best point "
                         "reaching interactive attainment >= 0.90 "
                         "without losing goodput")
    ap.add_argument("--trace-out", default=None,
                    help="also save each sweep point's trace (replayable "
                         "schedule archive)")
    ap.add_argument("--json", action="store_true",
                    help="suppress the tables; still prints the one "
                         "final JSON row")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engines run (default the card; no "
                         "GPU exits 1)")
    args = ap.parse_args(argv)
    try:
        args.sweep = [float(r) for r in str(args.sweep).split(",") if r]
    except ValueError as e:
        print(f"loadcheck: bad --sweep: {e}", file=sys.stderr)
        return 2
    if not args.drills_only and len(args.sweep) < 4:
        print(f"loadcheck: a goodput curve needs >= 4 load points, got "
              f"{len(args.sweep)}", file=sys.stderr)
        return 2
    if args.sweep_only and args.drills_only:
        print("loadcheck: --sweep-only and --drills-only are exclusive",
              file=sys.stderr)
        return 2
    if args.budget is not None:
        try:
            args.budget = [int(b) for b in str(args.budget).split(",")
                           if b]
        except ValueError as e:
            print(f"loadcheck: bad --budget: {e}", file=sys.stderr)
            return 2
        if not args.budget or min(args.budget) < 2:
            print("loadcheck: --budget needs integers >= 2 (one decode "
                  "token + a non-empty slice)", file=sys.stderr)
            return 2
        if args.spec_k:
            print("loadcheck: --budget is incompatible with --spec-k "
                  "(the engine rejects the pairing — see "
                  "runtime/speculative.py)", file=sys.stderr)
            return 2

    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("loadcheck: no GPU: torch.cuda.is_available() is False "
                  "— pass --device cpu to run on the CPU", file=sys.stderr)
            return 1
    from ..models.spec import TransformerSpec
    from ..runtime.chaos import (DISAGG_DRILLS, DRILLS, RECOVERY_DRILLS,
                                 TIERING_DRILLS, render_drill_table,
                                 run_drills)
    from ..utils.fingerprint import run_stamp

    make_engine = build_engine_factory(
        args, inject_leak=args.inject == "leak-on-cancel",
        inject_demote_drop=args.inject == "drop-on-demote")
    failures: list[str] = []
    rows: list[dict] = []
    drill_rows: list[dict] = []

    two_pool_row = None
    budget_row = None
    if args.two_pool:
        two_pool_row, tp_failures = run_two_pool(args, make_engine)
        failures += tp_failures
    elif args.budget is not None:
        budget_row, b_failures = run_budget(args, make_engine)
        failures += b_failures
    elif not args.drills_only:
        rows = run_sweep(args, make_engine)
        base_failures, _ = check_baseline(rows, args.baseline)
        failures += base_failures

    if not args.sweep_only:
        which = (set(args.drills.split(",")) if args.drills else None)
        if which is not None:
            # a typo'd drill name must be a usage error, not a vacuous
            # green gate with zero drills run
            known = {name for name, _ in DRILLS}
            unknown = sorted(which - known)
            if unknown:
                print(f"loadcheck: unknown drill(s) {', '.join(unknown)} "
                      f"(have: {', '.join(sorted(known))})",
                      file=sys.stderr)
                return 2
        results = run_drills(
            make_engine, which=which,
            inject={args.inject} if args.inject in ("corrupt-journal",
                                                    "drop-page-in-flight")
            else None, device=args.device)
        drill_rows = [r.to_json() for r in results]
        if not args.json:
            print(render_drill_table(results))
        failures += [f"drill {r.name}: {'; '.join(r.violations)}"
                     for r in results if not r.passed]
        if which is None:
            # the recovery and tiering gates must not pass VACUOUSLY: on
            # a full drill run, every drill the baseline names must have
            # run (the band file is where the expected-coverage contract
            # lives, next to the goodput bands)
            expected_recovery = RECOVERY_DRILLS
            expected_tiering = TIERING_DRILLS
            expected_disagg = DISAGG_DRILLS
            if os.path.exists(args.baseline):
                with open(args.baseline, encoding="utf-8") as fh:
                    doc = json.load(fh)
                expected_recovery = doc.get("recovery_drills",
                                            RECOVERY_DRILLS)
                expected_tiering = doc.get("tiering_drills",
                                           TIERING_DRILLS)
                expected_disagg = doc.get("disagg_drills", DISAGG_DRILLS)
            ran = {r.name for r in results}
            for name in expected_recovery:
                if name not in ran:
                    failures.append(f"recovery drill {name} named in the "
                                    f"baseline never ran")
            for name in expected_tiering:
                if name not in ran:
                    failures.append(f"tiering drill {name} named in the "
                                    f"baseline never ran")
            for name in expected_disagg:
                if name not in ran:
                    failures.append(f"disagg drill {name} named in the "
                                    f"baseline never ran")

    policy = _policy()
    row = {
        "kind": "loadcheck",
        **run_stamp(),  # env_fingerprint + tp_scheme + q40_body
        "config": {"slots": args.slots, "page_size": args.page_size,
                   "kv_pages": args.kv_pages, "spec_k": args.spec_k,
                   "block_steps": args.block_steps,
                   "step_cost_s": args.step_cost, "seed": args.seed,
                   "requests": args.requests, "arrivals": args.arrivals,
                   "model": dataclasses.asdict(
                       TransformerSpec(**SPEC_KW))},
        "slo": [{"class": c.name, "ttft_budget_s": c.ttft_budget_s,
                 "token_budget_s": c.token_budget_s}
                for c in policy.classes],
        "sweep": rows,
        "two_pool": two_pool_row,
        "budget": budget_row,
        "drills": drill_rows,
        # dedicated recovery-gate verdict columns: the crash-
        # safety drills' pass/fail at a glance, joinable across rows
        "recovery": {r["name"]: ("OK" if r["passed"] else "FAIL")
                     for r in drill_rows
                     if r["name"] in RECOVERY_DRILLS},
        # ... and the KV-tiering gate's
        "tiering": {r["name"]: ("OK" if r["passed"] else "FAIL")
                    for r in drill_rows
                    if r["name"] in TIERING_DRILLS},
        # ... and the disaggregation gate's
        "disagg": {r["name"]: ("OK" if r["passed"] else "FAIL")
                   for r in drill_rows
                   if r["name"] in DISAGG_DRILLS},
        "gate": {"verdict": "RED" if failures else "OK",
                 "failures": failures},
    }
    print(json.dumps(row))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
