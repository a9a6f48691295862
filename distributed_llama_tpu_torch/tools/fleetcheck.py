"""fleetcheck: per-replica signal rows + fleet rollup, gated like loadcheck
(the port's copy of the top-level tools/fleetcheck.py, over obs/fleet.py).

Two modes:

* ``--replicas URL,URL,...`` — scrape live servers' /health + /metrics
  on the wall clock (the operator view; unhealthy replicas are reported
  as unhealthy, never as idle);
* ``--sim N`` — the CI mode: N synthetic-weight engines driven by ONE
  seeded loadgen trace partitioned round-robin (the router stand-in),
  each on loadgen's VIRTUAL clock, rows built through the SAME
  signals_from_health / parse_metrics / apply_metrics path a live
  scrape uses. Deterministic on any box: same seed ⇒ identical row, on
  the card (``--device cuda``, the default; without a GPU it exits 1) as
  on the CPU.

This surface — ``kv_pages_free``, ``queue_depth``, goodput, prefix-tree
occupancy per replica, attainment/goodput/pages-free/hit-rate rollups —
is what a cache-aware router consumes.

The final stdout line is one JSON row (fingerprint-stamped, loadcheck's
convention). Exit 0 = rows consistent and (sim) audits clean; 1 = a
gate failure; 2 = usage error.

Usage:
  python3 -m distributed_llama_tpu_torch.tools.fleetcheck --sim 4
      [--seed N] [--requests N] [--rate R] [--slots N] [--page-size P]
      [--kv-pages N] [--json] [--device cuda|cpu]
  python3 -m distributed_llama_tpu_torch.tools.fleetcheck
      --replicas http://h1:9990,http://h2:9990 [--json]
"""

from __future__ import annotations

import argparse
import json
import sys

from .loadcheck import require_device



def _sim_health_payload(eng, duration: float) -> dict:
    """A drained sim engine's state in the server's /health JSON shape —
    the sim exercises the same parse path a live scrape takes, so a
    /health field rename breaks the deterministic CI gate, not a router
    in production."""
    active = sum(not s.free for s in eng._pool)
    with eng._lock:
        queued = len(eng._queue)
    payload = {
        "state": "serving", "active": active, "queued": queued,
        "queue_depth": queued, "slots": eng.slots,
        "steps": eng.stats.steps,
        "generated_tokens": eng.stats.tokens,
        "uptime_s": round(duration, 6),
        "occupancy": round(active / eng.slots, 4),
    }
    if eng.allocator is not None:
        a = eng.allocator
        payload["paged_kv"] = {
            "page_size": a.page_size, "pages": a.n_pages,
            "pages_free": a.n_free,
            "prefix_hit_rate": round(a.hit_rate, 4),
            "prefix_hits": a.prefix_hits,
            "prefix_misses": a.prefix_misses,
            "prefill_tokens_saved": a.tokens_saved,
            "evictions": a.evictions,
        }
    payload["sched"] = _sim_sched_block(eng)
    return payload


# the sim's deterministic seconds-per-step: the ledger's wall-clock
# float charges vary run to run (the CI gate byte-compares two runs), so
# the sim recomputes every cost second from the INTEGER step counts at a
# fixed rate. The rollup math under test — sums, recomputed ratios — is
# rate-invariant.
SIM_SEC_PER_STEP = 1e-3


def _sim_sched_block(eng, sec_per_step: float = SIM_SEC_PER_STEP) -> dict:
    """The /health "sched" block (runtime/server.py shape) rebuilt from
    the engine's ledger/census INTEGER counts on the virtual clock —
    same parse path as a live scrape, byte-stable across runs."""
    book, census = eng.ledger_book, eng.sched_census
    by_class = {}
    for cls, cell in book.class_rollup().items():
        toks = cell.get("tokens", 0)
        compute_steps = (cell.get("decode_row_steps", 0)
                         + cell.get("prefill_chunks", 0))
        by_class[cls] = {
            "tokens": toks,
            "requests": cell.get("requests", 0),
            "page_steps": cell.get("page_steps", 0),
            "compute_s": round(compute_steps * sec_per_step, 9),
            "page_s": round(cell.get("page_steps", 0) * sec_per_step, 9),
            "stall_s_total": round(
                sum(cell.get("stall_steps", {}).values()) * sec_per_step,
                9),
        }
    totals = book.grand_totals()
    cost_totals = {
        "requests": totals["requests"],
        "tokens": totals["tokens"],
        "page_steps": totals["page_steps"],
        "page_s": round(totals["page_steps"] * sec_per_step, 9),
        "stall_steps_total": totals["stall_steps_total"],
        "stall_s": {c: round(k * sec_per_step, 9) for c, k
                    in sorted(totals["stall_steps"].items())},
    }
    return {
        "census": census.totals(),
        "ledgers": {"opened": book.opened_n, "closed": book.closed_n,
                    "open": book.n_open},
        "cost_totals": cost_totals,
        "cost_by_class": by_class,
    }


def run_sim(args) -> tuple[list, "object", list[str], "object"]:
    """N replicas, one trace, round-robin routing, virtual clocks."""
    from .loadcheck import _load_spec, _policy, build_engine_factory
    from .loadgen import Trace, drive_engine, generate_trace
    from .watchcheck import _Feed

    from ..obs.fleet import (apply_metrics,
                                                 parse_metrics, rollup,
                                                 signals_from_health)
    from ..obs.watch import Watchtower

    make_engine = build_engine_factory(args)
    policy = _policy()
    trace = generate_trace(_load_spec(args.rate, args), args.seed)
    failures: list[str] = []
    rows = []
    # ONE shared watchtower over the whole sim fleet — each replica's
    # drive feeds it per-scheduler-tick through the same
    # sample_from_engine path watchcheck gates, so the fleet row carries
    # deterministic incident columns (surfaced, not gated: the
    # detection matrix itself is watchcheck's job)
    tower = Watchtower(spans=None)
    for k in range(args.sim):
        events = [e for i, e in enumerate(trace.events)
                  if i % args.sim == k]
        sub = Trace(seed=trace.seed, spec=trace.spec, events=events)
        eng = make_engine()
        feed = _Feed(tower, replica=f"replica-{k}")

        def on_tick(v, finished, feed=feed, eng=eng):
            for rec in finished:
                feed.settle(rec, policy)
            feed.tick(eng)

        res = drive_engine(eng, sub, policy, on_tick=on_tick)
        row = signals_from_health(f"replica-{k}",
                                  _sim_health_payload(eng, res.duration))
        # the /metrics half of the scrape path, against the engine's own
        # registry exposition (counter-backed fields cross-fill)
        apply_metrics(row, parse_metrics(eng._obs.registry.expose()))
        # SLO verdicts come from the virtual clock (res), the same
        # evaluate() a live server's tracker runs on the wall clock
        for cls, counts in res.by_class.items():
            row.slo[cls] = {
                "attempted": sum(counts.values()),
                "met": counts.get("met", 0),
                "violated": counts.get("violated", 0),
                "failed": counts.get("failed", 0),
                "goodput_tokens": 0,
            }
        row.goodput_tokens = res.goodput_tokens
        if row.present is not None:
            # the virtual clock IS this row's SLO tracker: the verdicts
            # injected above make the block present, or the rollup's
            # absent-block guard would skip the sim's goodput
            row.present.add("slo")
        audit = eng.audit_pages()
        if audit:
            failures += [f"replica-{k} audit: {p}" for p in audit]
            row.healthy = False
            row.error = "; ".join(audit)
        rows.append(row)
    agg = rollup(rows)
    # rollup self-consistency: the aggregate must be the recomputed sum
    # of its healthy rows — the math the router will trust
    healthy = [r for r in rows if r.healthy]
    checks = (
        ("kv_pages_free", sum(r.kv_pages_free for r in healthy),
         agg.kv_pages_free),
        ("queue_depth", sum(r.queue_depth for r in healthy),
         agg.queue_depth),
        ("goodput_tokens", sum(r.goodput_tokens for r in healthy),
         agg.goodput_tokens),
        ("prefix_hits", sum(r.prefix_hits for r in healthy),
         agg.prefix_hits),
        # cost columns: the rollup's cost cells must be the
        # recomputed sums of the healthy rows' cells — same order of
        # addition, so floats compare EXACTLY
        ("page_seconds", sum(r.page_seconds for r in healthy),
         agg.page_seconds),
        ("cost_tokens",
         sum(c.get("tokens", 0) for r in healthy
             for c in r.cost_classes.values()),
         sum(c.get("tokens", 0) for c in agg.cost_classes.values())),
        ("stall_seconds",
         round(sum(s for r in healthy
                   for s in r.stall_seconds.values()), 9),
         round(sum(agg.stall_seconds.values()), 9)),
    )
    for name, want, got in checks:
        if want != got:
            failures.append(f"rollup {name} = {got}, expected the "
                            f"summed {want}")
    if agg.healthy != len(healthy):
        failures.append(f"rollup healthy = {agg.healthy}, expected "
                        f"{len(healthy)}")
    if agg.spans_dropped != sum(r.spans_dropped for r in healthy):
        failures.append(
            f"rollup spans_dropped = {agg.spans_dropped}, expected "
            f"{sum(r.spans_dropped for r in healthy)}")
    return rows, agg, failures, tower


def run_scrape(args) -> tuple[list, "object", list[str], None]:
    from ..obs.fleet import rollup, scrape_replica

    urls = [u for u in args.replicas.split(",") if u]
    rows = [scrape_replica(f"replica-{i}", url, timeout=args.timeout)
            for i, url in enumerate(urls)]
    agg = rollup(rows, stale_after=args.stale_after)
    failures = []
    if agg.healthy == 0:
        failures.append("no healthy replica answered the scrape")
    return rows, agg, failures, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fleetcheck",
        description="per-replica signal rows + fleet rollup over "
                    "/health + /metrics (live scrape or deterministic "
                    "virtual-clock sim)")
    ap.add_argument("--replicas", default=None,
                    help="comma-separated base URLs of live servers")
    ap.add_argument("--timeout", type=float, default=5.0,
                    help="(--replicas) per-request scrape timeout, "
                         "seconds")
    ap.add_argument("--stale-after", type=float, default=None,
                    metavar="S",
                    help="(--replicas) count a row STALE (excluded "
                         "from sums) when its scrape stamp is older "
                         "than S seconds")
    ap.add_argument("--sim", type=int, default=0, metavar="N",
                    help="simulate an N-replica fleet on the virtual "
                         "clock (deterministic; the CI mode)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rate", type=float, default=0.4,
                    help="(--sim) offered arrivals per virtual step "
                         "across the whole fleet")
    ap.add_argument("--requests", type=int, default=32,
                    help="(--sim) total requests across the fleet")
    ap.add_argument("--arrivals", default="bursty",
                    choices=("poisson", "bursty"))
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=4)
    ap.add_argument("--kv-pages", type=int, default=20)
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--block-steps", type=int, default=1)
    ap.add_argument("--json", action="store_true",
                    help="suppress the table; still prints the one "
                         "final JSON row")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="(--sim) where the engines run (default the "
                         "card)")
    args = ap.parse_args(argv)
    if bool(args.replicas) == bool(args.sim):
        print("fleetcheck: exactly one of --replicas / --sim N",
              file=sys.stderr)
        return 2
    if args.sim and args.sim < 1:
        print(f"fleetcheck: --sim wants >= 1 replica, got {args.sim}",
              file=sys.stderr)
        return 2

    if args.sim and not require_device("fleetcheck", args.device):
        return 1
    from ..utils.fingerprint import run_stamp

    if args.sim:
        rows, agg, failures, tower = run_sim(args)
    else:
        rows, agg, failures, tower = run_scrape(args)

    if not args.json:
        print(f"{'replica':<12} {'ok':<3} {'state':<9} {'act':>3} "
              f"{'queue':>5} {'pages_free':>10} {'hit_rate':>8} "
              f"{'goodput':>8} {'tokens':>7}")
        for r in rows:
            print(f"{r.name:<12} {'y' if r.healthy else 'N':<3} "
                  f"{r.state:<9} {r.active:>3} {r.queue_depth:>5} "
                  f"{r.kv_pages_free:>10} {r.prefix_hit_rate:>8.2f} "
                  f"{r.goodput_tokens:>8} {r.generated_tokens:>7}")
        att = " ".join(f"{c}={a:.2f}" for c, a in agg.attainment.items())
        print(f"fleet: {agg.healthy}/{agg.replicas} healthy, "
              f"{agg.kv_pages_free}/{agg.kv_pages} pages free, "
              f"queue {agg.queue_depth}, hit rate "
              f"{agg.prefix_hit_rate:.2f}, goodput "
              f"{agg.goodput_tokens} tok, attainment {att}")
        cost = " ".join(
            f"{c}={cell['cost_per_token_s'] * 1e3:.3f}ms/tok"
            for c, cell in agg.cost.items())
        print(f"cost:  page_s {agg.page_seconds:.3f}, "
              f"{agg.cost_per_goodput_token * 1e3:.3f} ms/goodput-tok, "
              f"per-class {cost or '(no ledgers)'}")
        if agg.stale or agg.spans_dropped:
            print(f"aging: {agg.stale} stale row(s), "
                  f"{agg.spans_dropped} span(s) dropped fleet-wide")
        if tower is not None:
            kinds = " ".join(f"{k}={n}" for k, n
                             in sorted(tower.by_kind().items()))
            print(f"watch: {tower.incidents_total} incident(s) over "
                  f"{tower.ring.rows_total} tick(s)"
                  + (f" [{kinds}]" if kinds else ""))
        for f in failures:
            print(f"fleetcheck: {f}", file=sys.stderr)

    mode_cfg = {"mode": "sim" if args.sim else "scrape",
                "replicas": args.sim or len(rows), "seed": args.seed,
                "rate": args.rate, "requests": args.requests,
                "arrivals": args.arrivals, "slots": args.slots,
                "page_size": args.page_size, "kv_pages": args.kv_pages,
                "timeout": args.timeout, "stale_after": args.stale_after}
    row = {
        "kind": "fleetcheck",
        **run_stamp(),
        "config": mode_cfg,
        "rows": [r.to_json() for r in rows],
        "rollup": agg.to_json(),
        # the sim fleet's incident plane: deterministic (virtual clocks,
        # integer ring columns), so two runs' rows compare byte for byte
        "watch": tower.to_json(tail=0) if tower is not None else None,
        "gate": {"verdict": "RED" if failures else "OK",
                 "failures": failures},
    }
    print(json.dumps(row))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
