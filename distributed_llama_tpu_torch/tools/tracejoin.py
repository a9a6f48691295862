"""tracejoin: stitch two pools' span exports into ONE Chrome trace (the
port's copy of the top-level tools/tracejoin.py).

A disaggregated request's
timeline lives in two processes — the prefill pool's spans and the
decode pool's — each exported as NDJSON (``GET /debug/timeline?format=
ndjson``, or ``SpanTracer.export_ndjson``) on its OWN clock (each
tracer's perf_counter epoch). This tool joins them:

* **clock-skew alignment** anchored on the handoff send/recv span pair
  (runtime/disagg.SPAN_HANDOFF_SEND / SPAN_HANDOFF_RECV): the recv span
  is, by construction, contained within its send span, so centering
  each recv on its send estimates the epoch offset — the classic
  RPC-midpoint skew estimate. Multiple pairs average.
* **orphan refusal**: a handoff send with no recv parented on it, a
  recv without its sender, or a continuation link span whose parent is
  absent means trace propagation BROKE somewhere — the tool lists the
  orphans and exits 1 rather than emitting a trace that silently
  pretends the pools joined. (The seeded drop-traceparent mutation
  proves this gate can fail: it must exit EXACTLY 1.)
* the output is one Chrome-trace/Perfetto JSON (validated by
  obs/spans.validate_chrome_trace before it is ever written) with one
  pid lane per pool.

``--drill`` runs the self-contained two-pool verification: a real
DisaggPair over the TCP page channel (the kill_mid_handoff drill's
engine recipe, on ``--device``: the card by default; without a GPU
``--device cuda`` exits 1), both pools' NDJSON exports stitched and
checked —
zero orphans, >= 1 anchor pair, >= 1 trace joining both pools — plus,
with ``--flightrec-out``, a watchdog-triggered flight-recorder bundle
written and validated (obs/flightrec). ``--inject drop-traceparent``
arms the chaos mutation; the drill must then exit 1.

Usage:
  python3 -m distributed_llama_tpu_torch.tools.tracejoin POOL_A.ndjson
      POOL_B.ndjson [--label-a NAME] [--label-b NAME] [--chrome-out PATH]
      [--json]
  python3 -m distributed_llama_tpu_torch.tools.tracejoin --drill
      [--inject drop-traceparent] [--chrome-out PATH]
      [--flightrec-out PATH] [--json] [--device cuda|cpu]

Exit codes: 0 = joined clean; 1 = orphan spans / missing anchor /
drill failure; 2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .loadcheck import require_device


SEND = "handoff"           # runtime/disagg.SPAN_HANDOFF_SEND
RECV = "prefill_handoff"   # runtime/disagg.SPAN_HANDOFF_RECV
CAT = "handoff"            # runtime/disagg.HANDOFF_CAT — the category
#                            distinguishes the send/recv RPC spans from
#                            the zero-duration 'handoff' LINK span
#                            (cat 'link') a continuation records


def _is_send(rec: dict) -> bool:
    return rec.get("span") == SEND and rec.get("cat") == CAT


def _is_recv(rec: dict) -> bool:
    return rec.get("span") == RECV and rec.get("cat") == CAT


def load_ndjson_spans(path: str) -> tuple[list[dict], int]:
    """One pool's NDJSON export -> (span records, ring-dropped count).
    The trailing ``_meta`` overflow record (obs/spans) is consumed, not
    returned as a span."""
    spans: list[dict] = []
    dropped = 0
    with open(path, encoding="utf-8") as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}") from e
            if not isinstance(rec, dict) or "span" not in rec:
                raise ValueError(f"{path}:{i + 1}: not a span record")
            if rec.get("span") == "_meta":
                dropped += int(rec.get("dropped", 0))
                continue
            spans.append(rec)
    return spans, dropped


def _mid(rec: dict) -> float:
    return float(rec["t_start_s"]) + float(rec["dur_ms"]) / 2e3


def find_anchor_pairs(spans_a: list, spans_b: list) -> list[tuple]:
    """(send, recv, recv_in_b) pairs across the two pools: a recv span
    parented on a send span from the OTHER pool. Either pool may be the
    sender (a decode pool initiates against prefill, but the harness
    may hand either export in either position)."""
    pairs = []
    for sends, recvs, recv_in_b in ((spans_a, spans_b, True),
                                    (spans_b, spans_a, False)):
        by_id = {s.get("span_id"): s for s in sends
                 if _is_send(s) and s.get("span_id")}
        for r in recvs:
            if not _is_recv(r):
                continue
            s = by_id.get(r.get("parent_span_id"))
            if s is not None and s.get("trace_id") == r.get("trace_id"):
                pairs.append((s, r, recv_in_b))
    return pairs


def find_orphans(spans_a: list, spans_b: list) -> list[str]:
    """The propagation-break detector (module docstring): unmatched
    sends, sender-less recvs, and unparented continuation links."""
    joined = spans_a + spans_b
    all_ids = {s.get("span_id") for s in joined if s.get("span_id")}
    paired_sends = set()
    paired_recvs = set()
    for s, r, _ in find_anchor_pairs(spans_a, spans_b):
        paired_sends.add(id(s))
        paired_recvs.add(id(r))
    orphans = []
    for rec in joined:
        if _is_send(rec) and id(rec) not in paired_sends:
            orphans.append(
                f"handoff send {rec.get('span_id')} (trace "
                f"{rec.get('trace_id')}) has no recv span parented on "
                f"it — the traceparent never reached the peer")
        elif _is_recv(rec) and id(rec) not in paired_recvs:
            orphans.append(
                f"handoff recv {rec.get('span_id')} (trace "
                f"{rec.get('trace_id')}) has no matching send — it "
                f"arrived without (or with a broken) traceparent")
        elif rec.get("cat") == "link" \
                and rec.get("link") != "recovers" \
                and rec.get("parent_span_id") not in all_ids:
            # 'recovers' links are exempt: their parent span lived in a
            # PREVIOUS process life whose tracer died with it — an
            # absent parent there is the expected post-crash state, not
            # a propagation break (the handoff send/recv rules above
            # still catch every dropped traceparent)
            orphans.append(
                f"link span {rec.get('span_id')} ({rec.get('link')}, "
                f"trace {rec.get('trace_id')}) parents on "
                f"{rec.get('parent_span_id')}, absent from the joined "
                f"set")
    return orphans


def join_pools(spans_a: list, spans_b: list, label_a: str = "pool-a",
               label_b: str = "pool-b") -> tuple[dict, dict]:
    """Stitch two pools' span records into one Chrome trace. Returns
    (chrome_doc, report); the caller refuses on report['orphans'] or a
    missing anchor. Pool B's clock is shifted onto pool A's by the
    averaged anchor-pair midpoint offset."""
    pairs = find_anchor_pairs(spans_a, spans_b)
    orphans = find_orphans(spans_a, spans_b)
    offsets = []
    for send, recv, recv_in_b in pairs:
        # shift B so each recv midpoint lands on its send midpoint
        if recv_in_b:
            offsets.append(_mid(send) - _mid(recv))
        else:
            offsets.append(_mid(recv) - _mid(send))
    offset_b = sum(offsets) / len(offsets) if offsets else 0.0
    traces_a = {s.get("trace_id") for s in spans_a} - {None}
    traces_b = {s.get("trace_id") for s in spans_b} - {None}
    report = {
        "pairs": len(pairs),
        "offset_s": round(offset_b, 6),
        "orphans": orphans,
        "spans": {label_a: len(spans_a), label_b: len(spans_b)},
        "traces_joined": sorted(traces_a & traces_b),
    }
    # one pid lane per pool, timestamps on pool A's clock, shifted
    # non-negative for the viewer
    shifted = ([(s, 0.0, 1) for s in spans_a]
               + [(s, offset_b, 2) for s in spans_b])
    t_min = min((float(s["t_start_s"]) + off for s, off, _ in shifted),
                default=0.0)
    events = [
        {"name": "process_name", "ph": "M", "ts": 0, "pid": 1,
         "args": {"name": label_a}},
        {"name": "process_name", "ph": "M", "ts": 0, "pid": 2,
         "args": {"name": label_b}},
    ]
    for rec, off, pid in shifted:
        args = {k: v for k, v in rec.items()
                if k not in ("span", "cat", "t_start_s", "dur_ms", "tid")}
        events.append({
            "name": rec["span"], "cat": rec.get("cat", "phase"),
            "ph": "X",
            "ts": max(round((float(rec["t_start_s"]) + off - t_min) * 1e6,
                            3), 0.0),
            "dur": round(float(rec["dur_ms"]) * 1e3, 3),
            "pid": pid, "tid": rec.get("tid", 0),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}, report


# ------------------------------------------------------------- the drill


def run_drill(inject: set, chrome_out: str | None,
              flightrec_out: str | None, emit_json: bool,
              device: str = "cuda") -> int:
    """The self-contained two-pool verification (module docstring)."""
    import tempfile
    import time

    from ..obs.flightrec import (FlightRecorder,
                                                     load_bundle)
    from ..obs.spans import validate_chrome_trace
    from ..runtime.chaos import (_HANDOFF_REQS,
                                                     ChaosMonkey,
                                                     _disagg_decode_engine,
                                                     _recovery_engine)
    from ..runtime.disagg import DisaggPair
    from ..runtime.journal import RequestJournal

    tmp = tempfile.mkdtemp(prefix="dllama-tracejoin-")
    chaos = ChaosMonkey(drop_traceparent="drop-traceparent" in inject)
    prefill = _recovery_engine(
        journal=RequestJournal(os.path.join(tmp, "prefill.journal")),
        device=device)
    jd_path = os.path.join(tmp, "decode.journal")
    decode = _disagg_decode_engine(RequestJournal(jd_path), device=device)
    pair = DisaggPair(prefill, decode, channel_host="127.0.0.1",
                      chaos=chaos)
    failures: list[str] = []
    try:
        outs, summary = pair.run(
            [list(tokens) for tokens, *_rest in _HANDOFF_REQS],
            steps=_HANDOFF_REQS[0][1])
        if summary["shipped"] < 2:
            failures.append(f"expected 2 shipped handoffs, got "
                            f"{summary['shipped']}")
        path_d = os.path.join(tmp, "decode.ndjson")
        path_p = os.path.join(tmp, "prefill.ndjson")
        with open(path_d, "w", encoding="utf-8") as fh:
            fh.write(decode._spans.export_ndjson())
        with open(path_p, "w", encoding="utf-8") as fh:
            fh.write(prefill._spans.export_ndjson())
        spans_d, _ = load_ndjson_spans(path_d)
        spans_p, _ = load_ndjson_spans(path_p)
        doc, report = join_pools(spans_d, spans_p, "decode", "prefill")
        validate_chrome_trace(doc)
        if report["orphans"]:
            failures += [f"orphan: {o}" for o in report["orphans"]]
        if report["pairs"] < 1:
            failures.append("no handoff send/recv anchor pair — the two "
                            "pools' clocks cannot be aligned")
        if not report["traces_joined"]:
            failures.append("no trace spans BOTH pools — the stitched "
                            "timeline is two unrelated timelines")
        if chrome_out and not failures:
            os.makedirs(os.path.dirname(os.path.abspath(chrome_out)),
                        exist_ok=True)
            with open(chrome_out, "w", encoding="utf-8") as fh:
                json.dump(doc, fh)
                fh.write("\n")
    finally:
        pair.close()

    if flightrec_out and not failures:
        # the watchdog leg: a deliberately hung "dispatch" trips the
        # StepWatchdog, whose on_hang dumps the bundle — then the bundle
        # must load + validate (the same check tracecheck applies)
        from ..runtime.supervisor import StepWatchdog

        rec = FlightRecorder(registry=decode._obs.registry,
                             spans=decode._spans, journal_path=jd_path,
                             config={"drill": "tracejoin",
                                     "page_size": decode.page_size})
        fired: list[float] = []
        wd = StepWatchdog(0.02, on_hang=lambda el: (
            fired.append(el), rec.note("watchdog", elapsed_s=el)))
        try:
            with wd:
                time.sleep(0.1)  # the hung dispatch the watchdog must see
        finally:
            wd.close()
        if not fired:
            failures.append("watchdog never fired under the injected "
                            "stall — no bundle trigger to verify")
        else:
            path = rec.dump(flightrec_out, "watchdog")
            try:
                bundle = load_bundle(path)
                if not bundle["spans"]:
                    failures.append("flight-recorder bundle carries no "
                                    "spans from the two-pool run")
                if "dllama_" not in bundle["metrics"]:
                    failures.append("flight-recorder bundle carries no "
                                    "metrics exposition")
                if not bundle["journal_tail"]:
                    failures.append("flight-recorder bundle carries no "
                                    "journal tail")
            except ValueError as e:
                failures.append(f"flight-recorder bundle invalid: {e}")

    verdict = {"verdict": "RED" if failures else "OK",
               "failures": failures,
               "dropped_traceparents": chaos.dropped_traceparents}
    if emit_json:
        print(json.dumps(verdict))
    else:
        for f in failures:
            print(f"tracejoin drill: {f}", file=sys.stderr)
        print(f"tracejoin drill: {verdict['verdict']}")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tracejoin",
        description="stitch two pools' NDJSON span exports into one "
                    "skew-aligned Chrome trace; refuse on orphan spans")
    ap.add_argument("exports", nargs="*",
                    help="two NDJSON span exports "
                         "(GET /debug/timeline?format=ndjson)")
    ap.add_argument("--label-a", default="pool-a")
    ap.add_argument("--label-b", default="pool-b")
    ap.add_argument("--chrome-out", default=None,
                    help="write the stitched Chrome trace here")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--drill", action="store_true",
                    help="run the self-contained two-pool verification "
                         "(real TCP page channel) instead of reading "
                         "export files")
    ap.add_argument("--inject", default=None,
                    choices=("drop-traceparent",),
                    help="(--drill) arm the seeded traceparent-drop "
                         "mutation; the drill MUST then exit 1 (the CI "
                         "gate's self-test)")
    ap.add_argument("--flightrec-out", default=None,
                    help="(--drill) also run the watchdog leg and write "
                         "the flight-recorder bundle here (.json)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="(--drill) where the two pools' engines run "
                         "(default the card)")
    args = ap.parse_args(argv)

    if args.drill:
        if args.exports:
            print("tracejoin: --drill takes no export files",
                  file=sys.stderr)
            return 2
        if not require_device("tracejoin", args.device):
            return 1
        return run_drill({args.inject} if args.inject else set(),
                         args.chrome_out, args.flightrec_out, args.json,
                         args.device)
    if args.inject or args.flightrec_out:
        print("tracejoin: --inject/--flightrec-out need --drill",
              file=sys.stderr)
        return 2
    if len(args.exports) != 2:
        print("tracejoin: exactly two NDJSON exports required "
              "(or --drill)", file=sys.stderr)
        return 2

    from ..obs.spans import validate_chrome_trace

    try:
        spans_a, drop_a = load_ndjson_spans(args.exports[0])
        spans_b, drop_b = load_ndjson_spans(args.exports[1])
    except (OSError, ValueError) as e:
        print(f"tracejoin: {e}", file=sys.stderr)
        return 2
    doc, report = join_pools(spans_a, spans_b, args.label_a, args.label_b)
    report["ring_dropped"] = {args.label_a: drop_a, args.label_b: drop_b}
    if drop_a or drop_b:
        print(f"tracejoin: WARNING ring overflow dropped spans "
              f"({args.label_a}: {drop_a}, {args.label_b}: {drop_b}) — "
              f"the stitched window is truncated", file=sys.stderr)
    ok = not report["orphans"] and report["pairs"] >= 1
    if args.chrome_out and ok:
        validate_chrome_trace(doc)  # never archive a malformed artifact
        os.makedirs(os.path.dirname(os.path.abspath(args.chrome_out)),
                    exist_ok=True)
        with open(args.chrome_out, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
            fh.write("\n")
        print(f"tracejoin: chrome trace -> {args.chrome_out}",
              file=sys.stderr)
    if args.json:
        print(json.dumps({"ok": ok, **report}))
    else:
        print(f"pairs={report['pairs']} offset_s={report['offset_s']} "
              f"spans={report['spans']} "
              f"traces_joined={len(report['traces_joined'])}")
        for o in report["orphans"]:
            print(f"ORPHAN: {o}", file=sys.stderr)
        if report["pairs"] < 1:
            print("tracejoin: no handoff anchor pair — refusing to "
                  "stitch unaligned clocks", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
