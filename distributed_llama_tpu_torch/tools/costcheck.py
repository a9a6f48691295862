"""costcheck: the accounting plane's conservation gate (the port's copy of
the top-level tools/costcheck.py, over the port's engines, obs/ledger.py
and tools/loadgen.py).

The request-level cost ledger (obs/ledger.py) bills every request its
share of each dispatch — row-steps, tokens, KV page-seconds, stall time
by cause, ICI/DCN bytes — while the per-dispatch census ring records the
same quantities from the ENGINE side, through independent arithmetic.
This tool replays seeded loadgen traces on the VIRTUAL clock and holds
the two sides to each other EXACTLY (integer step units — no tolerance):

    Σ per-request decode row-steps == census row-steps == stats.sum_active
    Σ per-request tokens           == census decode+prefill == stats.tokens
    Σ per-request prefill chunks   == stats.prefill_chunks
    Σ per-request page-steps       == census page-steps
    Σ per-request stall-steps      == census (parked+queued) x steps
    Σ per-request spec proposals   == census spec tokens
    zero ledgers still open after drain; one ledger per trace event

Legs (each a fresh engine, loadcheck's synthetic-weight config):

* ``healthy``  — plain drive_engine replay; the base equalities.
* ``spec``     — same with speculative decoding on (spec_k=2): proposal/
  acceptance accounting joins the conservation set.
* ``cancel``   — cancels a third of the requests (a mix of still-queued
  and mid-flight) and requires the books to still balance: a cancelled
  request's bill closes exactly once, never leaks, never double-folds.
* ``recovery`` — kills an engine mid-decode (journal abandoned, never
  drained) and recovers into a fresh engine on the same journal: every
  re-admitted life opens exactly one new ledger, carries the journaled
  bill, and the recovered engine's books balance after drain.
* ``mixed``    — token-budget scheduling on (dispatch_tokens=8): every
  dispatch is a ``kind="mixed"`` census row carrying decode rows + one
  prefill slice; the SAME equalities must hold (mixed decode
  rows bill as row-steps, slice tokens as prefill tokens, deferred rows
  as budget_wait stalls), and zero budget overruns.
* ``disagg``   — the two-pool handoff (runtime/disagg.py): per-engine
  conservation on the prefill pool, and the CROSS-SEAM equality on the
  decode pool — its ledgers fold the carried prefill-side bills, so
  decode-book totals minus the prefill-book totals must equal the decode
  engine's own census. The DCN page/byte bill and handoff-wait stall
  must be non-zero (the seam was actually billed).

``--inject double-count-dispatch`` arms the chaos mutation that bills
every ledger charge twice (census counts once): conservation MUST go
red, exit exactly 1. ``--inject leak-ledger`` swallows every ledger
close: the open-ledger audit must flag the leak.

The engines run on ``--device`` (default the card, as the port's
loadcheck); without a GPU, ``--device cuda`` exits 1. The books count
integer steps, so the card's row equals the CPU's.

The final stdout line is one JSON row stamped with
``utils/fingerprint.run_stamp`` carrying the healthy leg's grand totals
and per-class cost columns (cost-per-token, page-seconds-per-token) —
joinable with loadcheck/fleetcheck rows. Exit 0 = every leg conserves;
1 = a conservation failure; 2 = usage error.

Usage:
  python3 -m distributed_llama_tpu_torch.tools.costcheck [--seed N]
      [--requests N] [--rate R] [--slots N] [--page-size P] [--kv-pages N]
      [--block-steps K] [--legs healthy,spec,cancel,recovery,disagg,mixed]
      [--inject double-count-dispatch|leak-ledger] [--json]
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

from .loadcheck import require_device

LEGS = ("healthy", "spec", "cancel", "recovery", "disagg", "mixed")

# the integer fields a carried (cross-seam) bill offsets in the decode-
# side comparison — the float wall-clock fields are never gated (they
# are honest but not reproducible)
_DRAIN_ITERS = 100_000


def _conservation_failures(tag: str, eng, carried: dict | None = None,
                           expect_requests: int | None = None) -> list[str]:
    """The exact equalities between one engine's ledger book (per-request
    side) and its census ring + stats (engine side). ``carried`` is a
    grand-totals dict of bills that entered this book from ANOTHER
    engine's life (recovery / handoff) — subtracted from the ledger side
    first, because that work was done (and census-counted) elsewhere."""
    book, census, st = eng.ledger_book, eng.sched_census, eng.stats
    t = book.grand_totals()
    c = census.totals()
    off = carried or {}
    fails: list[str] = []

    def eq(name: str, ledger_side, engine_side) -> None:
        if ledger_side != engine_side:
            fails.append(f"{tag}: {name}: ledger-side {ledger_side} != "
                         f"engine-side {engine_side}")

    eq("decode row-steps (vs census)",
       t["decode_row_steps"] - off.get("decode_row_steps", 0),
       c["row_steps"])
    eq("decode row-steps (vs stats.sum_active)",
       t["decode_row_steps"] - off.get("decode_row_steps", 0),
       st.sum_active)
    eq("tokens (vs census)", t["tokens"] - off.get("tokens", 0),
       c["tokens"]["decode"] + c["tokens"]["prefill"])
    eq("tokens (vs stats)", t["tokens"] - off.get("tokens", 0), st.tokens)
    eq("prefill chunks",
       t["prefill_chunks"] - off.get("prefill_chunks", 0),
       st.prefill_chunks)
    eq("page-steps", t["page_steps"] - off.get("page_steps", 0),
       c["page_steps"])
    eq("stall-steps",
       t["stall_steps_total"] - sum((off.get("stall_steps") or {})
                                    .values()),
       c["stall_steps"])
    eq("spec proposals", t["spec_proposed"] - off.get("spec_proposed", 0),
       c["tokens"]["spec"])
    eq("census steps (vs stats.steps)", c["steps"], st.steps)
    if book.n_open:
        fails.append(f"{tag}: {book.n_open} ledger(s) still open after "
                     f"drain (leaked or orphaned bills)")
    if expect_requests is not None and t["requests"] != expect_requests:
        fails.append(f"{tag}: book closed {t['requests']} request "
                     f"bills, the trace carries {expect_requests}")
    return fails


def _drain(eng) -> None:
    for _ in range(_DRAIN_ITERS):
        if eng._n_outstanding() == 0:
            return
        eng.step_many(eng.block_steps, quiet=True)
    raise RuntimeError("costcheck: engine refused to drain")


def _chaos_for(inject: str | None):
    if inject is None:
        return None
    from ..runtime.chaos import ChaosMonkey

    return ChaosMonkey(
        double_count_dispatch=inject == "double-count-dispatch",
        leak_ledger=inject == "leak-ledger")


def leg_healthy(args, make_engine, inject=None,
                spec_k: int = 0) -> tuple[dict, list[str]]:
    from .loadcheck import _load_spec, _policy
    from .loadgen import drive_engine, generate_trace

    tag = "spec" if spec_k else "healthy"
    trace = generate_trace(_load_spec(args.rate, args), args.seed)
    eng = make_engine(chaos=_chaos_for(inject), spec_k=spec_k)
    drive_engine(eng, trace, _policy())
    fails = _conservation_failures(tag, eng,
                                   expect_requests=len(trace.events))
    if spec_k and eng.sched_census.totals()["tokens"]["spec"] == 0:
        fails.append("spec: spec_k=2 replay proposed zero draft tokens "
                     "— the leg gates nothing")
    return {"engine": eng, "totals": eng.ledger_book.grand_totals(),
            "by_class": eng.ledger_book.class_rollup()}, fails


def leg_mixed(args, make_engine) -> tuple[dict, list[str]]:
    """Token-budget engine: same replay, every dispatch a
    kind="mixed" census row. Conservation is the point — mixed decode
    rows bill as plain row-steps, the piggybacked slice's tokens as
    prefill tokens, budget-deferred rows as budget_wait stalls — plus
    the budget's own invariant: zero overrun steps."""
    from .loadcheck import _load_spec, _policy
    from .loadgen import drive_engine, generate_trace

    trace = generate_trace(_load_spec(args.rate, args), args.seed)
    eng = make_engine(dispatch_tokens=8)
    drive_engine(eng, trace, _policy())
    fails = _conservation_failures("mixed", eng,
                                   expect_requests=len(trace.events))
    mixed_rows = sum(1 for e in eng.sched_census.tail(10_000)
                     if e["kind"] == "mixed")
    if mixed_rows == 0:
        fails.append("mixed: zero kind=mixed census rows — the engine "
                     "never took the token-budget path; the leg gates "
                     "nothing")
    if eng.stats.overrun_steps:
        fails.append(f"mixed: {eng.stats.overrun_steps} overrun step(s) "
                     f"on a healthy replay — the scheduler packed past "
                     f"its own budget")
    return {"mixed_dispatches": mixed_rows,
            "overrun_steps": eng.stats.overrun_steps}, fails


def leg_cancel(args, make_engine) -> tuple[dict, list[str]]:
    from ..runtime.continuous import Request
    from .loadcheck import _load_spec
    from .loadgen import generate_trace

    trace = generate_trace(_load_spec(args.rate, args), args.seed)
    eng = make_engine()
    reqs = []
    for e in sorted(trace.events, key=lambda ev: ev.t):
        req = Request(tokens=list(e.tokens), steps=e.steps,
                      slo_class=e.slo_class)
        eng.submit(req)
        reqs.append(req)
    # one chain in flight, then cancel every third request — the pool
    # now holds a mix of mid-prefill, mid-decode and still-queued
    # casualties, exactly the states a bill can leak from
    eng.step_many(eng.block_steps, quiet=True)
    cancelled = 0
    for i, req in enumerate(reqs):
        if i % 3 == 0 and not req.done.is_set():
            eng.cancel(req)
            cancelled += 1
    _drain(eng)
    fails = _conservation_failures("cancel", eng,
                                   expect_requests=len(trace.events))
    if cancelled == 0:
        fails.append("cancel: nothing was cancellable — the leg gates "
                     "nothing")
    return {"cancelled": cancelled}, fails


def leg_recovery(args, make_engine, tmpdir: str) -> tuple[dict, list[str]]:
    from ..runtime.continuous import Request
    from ..runtime.journal import RequestJournal
    from .loadcheck import _load_spec
    from .loadgen import generate_trace

    path = os.path.join(tmpdir, "costcheck_recovery.journal")
    trace = generate_trace(_load_spec(args.rate, args), args.seed)
    eng1 = make_engine(journal=RequestJournal(path))
    for e in sorted(trace.events, key=lambda ev: ev.t):
        eng1.submit(Request(tokens=list(e.tokens), steps=e.steps,
                            slo_class=e.slo_class))
    for _ in range(3):
        eng1.step_many(eng1.block_steps, quiet=True)
    # "kill" mid-decode: eng1 is abandoned with live slots and OPEN
    # ledgers — the crash forfeits the RAM-accrued bill (a WAL journals
    # admits, not per-step charges); what must survive is the INVARIANT:
    # the recovered engine's book balances on its own, every re-admitted
    # life opens exactly one ledger, none dangle after drain
    mid_flight = eng1.ledger_book.n_open
    journal = RequestJournal(path)
    carried: dict = {"stall_steps": {}}
    recovered_expect = 0
    for e in journal.incomplete():
        recovered_expect += 1
        for k, v in (e.ledger or {}).items():
            if isinstance(v, dict):
                cell = carried.setdefault(k, {})
                for kk, vv in v.items():
                    cell[kk] = cell.get(kk, 0) + vv
            elif isinstance(v, (int, float)):
                carried[k] = carried.get(k, 0) + v
    eng2 = make_engine(journal=journal)
    n = eng2.recover()
    _drain(eng2)
    fails = _conservation_failures("recovery", eng2, carried=carried,
                                   expect_requests=n)
    if n != recovered_expect:
        fails.append(f"recovery: recover() re-admitted {n} requests, "
                     f"the journal held {recovered_expect} incomplete")
    if n == 0 or mid_flight == 0:
        fails.append("recovery: the kill caught nothing mid-flight — "
                     "the leg gates nothing")
    if eng2.ledger_book.opened_n != n:
        fails.append(f"recovery: {eng2.ledger_book.opened_n} ledgers "
                     f"opened for {n} recovered requests")
    return {"recovered": n, "open_at_kill": mid_flight}, fails


def leg_disagg(args, make_engine) -> tuple[dict, list[str]]:
    from ..runtime.disagg import make_priority_hold
    from .loadcheck import SPEC_KW, _two_pool_policy, _two_pool_spec
    from .loadgen import drive_pools, generate_trace

    policy = _two_pool_policy()
    trace = generate_trace(_two_pool_spec(args), args.seed)
    slots = 2 * args.slots
    pages = slots * (SPEC_KW["seq_len"] // args.page_size)
    prefill = make_engine(slo=policy, slo_priority=True, slots=slots,
                          kv_pages=pages)
    prefill.prefill_hold = make_priority_hold(prefill, policy)
    decode = make_engine(remote_pages=True, slots=slots, kv_pages=pages)
    drive_pools([prefill, decode], trace, policy, mode="disagg")
    # prefill-pool conservation stands on its own; the decode pool's
    # book folds the CARRIED prefill-side bills (journal-record seam),
    # so subtracting the prefill book's totals must land exactly on the
    # decode engine's own census — the cross-seam conservation equality
    fails = _conservation_failures("disagg-prefill", prefill)
    carried = prefill.ledger_book.grand_totals()
    fails += _conservation_failures("disagg-decode", decode,
                                    carried=carried,
                                    expect_requests=len(trace.events))
    bd = decode.ledger_book.grand_totals()
    handed = carried["requests"]
    if handed == 0:
        fails.append("disagg: no request crossed the seam — the leg "
                     "gates nothing")
    if bd["dcn_pages"] <= 0 or bd["dcn_bytes"] <= 0:
        fails.append(f"disagg: {handed} handoffs billed dcn_pages="
                     f"{bd['dcn_pages']} dcn_bytes={bd['dcn_bytes']} — "
                     f"the DCN seam went unbilled")
    if bd["stall_s"].get("handoff_wait", 0.0) <= 0.0:
        fails.append("disagg: handoff_wait stall seconds were never "
                     "charged across the seam")
    return {"handed_off": handed, "dcn_pages": bd["dcn_pages"],
            "dcn_bytes": bd["dcn_bytes"],
            "handoff_wait_s": round(bd["stall_s"]
                                    .get("handoff_wait", 0.0), 6)}, fails


def _round_floats(obj):
    if isinstance(obj, float):
        return round(obj, 9)
    if isinstance(obj, dict):
        return {k: _round_floats(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_round_floats(v) for v in obj]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="costcheck",
        description="request-ledger vs scheduler-census conservation "
                    "gate on the virtual clock (exact, integer units)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=0.5,
                    help="offered arrivals per virtual step")
    ap.add_argument("--arrivals", default="bursty",
                    choices=("poisson", "bursty"))
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=4)
    ap.add_argument("--kv-pages", type=int, default=20)
    ap.add_argument("--spec-k", type=int, default=0,
                    help="base engine spec_k (the dedicated spec leg "
                         "always runs at spec_k=2)")
    ap.add_argument("--block-steps", type=int, default=2)
    ap.add_argument("--two-pool-rate", type=float, default=0.25,
                    help="offered rate of the disagg leg's mixed trace")
    ap.add_argument("--legs", default=",".join(LEGS),
                    help="comma-separated subset of: " + ", ".join(LEGS))
    ap.add_argument("--inject", default=None,
                    choices=("double-count-dispatch", "leak-ledger"),
                    help="arm a seeded accounting mutation on the "
                         "healthy leg; conservation MUST go red (the CI "
                         "gate's self-test): double-count-dispatch "
                         "bills every ledger charge twice while the "
                         "census counts once, leak-ledger swallows "
                         "every ledger close")
    ap.add_argument("--json", action="store_true",
                    help="suppress the table; still prints the one "
                         "final JSON row")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engines run (default the card)")
    args = ap.parse_args(argv)
    legs = [x for x in str(args.legs).split(",") if x]
    unknown = sorted(set(legs) - set(LEGS))
    if unknown:
        print(f"costcheck: unknown leg(s) {', '.join(unknown)} "
              f"(have: {', '.join(LEGS)})", file=sys.stderr)
        return 2
    if args.inject and "healthy" not in legs:
        print("costcheck: --inject arms the healthy leg; include it in "
              "--legs", file=sys.stderr)
        return 2

    if not require_device("costcheck", args.device):
        return 1
    from ..utils.fingerprint import run_stamp
    from .loadcheck import build_engine_factory

    make_engine = build_engine_factory(args)
    failures: list[str] = []
    leg_rows: dict = {}
    totals: dict = {}
    by_class: dict = {}
    with tempfile.TemporaryDirectory(prefix="costcheck_") as tmpdir:
        for name in legs:
            if name == "healthy":
                row, fails = leg_healthy(args, make_engine,
                                         inject=args.inject)
                totals = row.pop("totals")
                by_class = row.pop("by_class")
                row.pop("engine", None)
            elif name == "spec":
                row, fails = leg_healthy(args, make_engine, spec_k=2)
                row = {"spec_tokens":
                       row["engine"].sched_census.totals()
                       ["tokens"]["spec"]}
            elif name == "cancel":
                row, fails = leg_cancel(args, make_engine)
            elif name == "recovery":
                row, fails = leg_recovery(args, make_engine, tmpdir)
            elif name == "mixed":
                row, fails = leg_mixed(args, make_engine)
            else:
                row, fails = leg_disagg(args, make_engine)
            leg_rows[name] = {"verdict": "RED" if fails else "OK",
                              "failures": fails, **row}
            failures += fails
            if not args.json:
                extra = " ".join(f"{k}={v}" for k, v in row.items())
                print(f"leg {name:<9} "
                      f"{'RED' if fails else 'OK ':<3} {extra}")
                for f in fails:
                    print(f"costcheck: {f}", file=sys.stderr)

    if not args.json and by_class:
        print(f"{'class':<13} {'requests':>8} {'tokens':>7} "
              f"{'cost/tok(ms)':>12} {'page-s/tok(ms)':>14} "
              f"{'stall-s':>8}")
        for cls, cell in by_class.items():
            print(f"{cls:<13} {cell['requests']:>8} {cell['tokens']:>7} "
                  f"{cell['cost_per_token_s'] * 1e3:>12.4f} "
                  f"{cell['page_s_per_token'] * 1e3:>14.4f} "
                  f"{cell['stall_s_total']:>8.4f}")

    row = {
        "kind": "costcheck",
        **run_stamp(),
        "config": {"slots": args.slots, "page_size": args.page_size,
                   "kv_pages": args.kv_pages, "spec_k": args.spec_k,
                   "block_steps": args.block_steps, "seed": args.seed,
                   "rate": args.rate, "requests": args.requests,
                   "arrivals": args.arrivals, "legs": legs,
                   "inject": args.inject},
        "legs": leg_rows,
        "totals": _round_floats(totals),
        "cost_by_class": _round_floats(by_class),
        "gate": {"verdict": "RED" if failures else "OK",
                 "failures": failures},
    }
    print(json.dumps(row))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
