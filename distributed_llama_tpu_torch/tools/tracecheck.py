"""tracecheck: attribute a profiler capture and reconcile it against the
model (the port's copy of the top-level tools/tracecheck.py).

Loads a capture — a port ``--profile`` directory (``inference --profile
DIR``; at tp N each rank's trace is ``DIR/rank<r>/``, and the newest
``*.pt.trace.json`` under the path given is read), a ``*.pt.trace.json``
file, or a ``dllama-trace/1`` synthetic fixture — buckets its events by
the phase spans the forward opens (obs/spans.py via obs/xprof.py), and
joins the measured collective census against
``comm_stats.tp_collective_budget`` + ``shard_sim.modeled_ici_ms`` for the
named (model, tp, scheme) config (obs/drift.py). Prints the verdict table;
exit 0 = every check OK (or SKIP), 1 = DRIFT, 2 = usage error.

Fixtures carry their config in the header; a Chrome trace needs
``--model/--tp/--scheme`` (its token count is the forwards it holds,
unless ``--tokens`` says otherwise). A flight-recorder bundle
(obs/flightrec.py) is validated and summarised instead.

``--chrome-out`` also writes the attribution as a Chrome-trace/Perfetto
JSON artifact (per-phase and per-collective lanes laid out sequentially
per token).

Usage:
  python3 -m distributed_llama_tpu_torch.tools.tracecheck CAPTURE
      [--model 7b|13b|70b|small|MODEL.bin] [--tp N]
      [--scheme ref|fused|overlap] [--buffer f32|q80] [--tokens N]
      [--chrome-out PATH] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def attribution_chrome_trace(att, report) -> dict:
    """The attribution as a Chrome-trace object: one 'X' lane per phase
    (per-token ms, laid out sequentially) and one per collective kind,
    plus a metadata event carrying the verdict."""
    from ..obs.spans import Span, spans_to_chrome

    spans, t = [], 0.0
    for phase, ms in sorted(att.phase_ms.items()):
        per_tok = ms / max(att.tokens, 1) / 1e3  # seconds/token
        spans.append(Span(phase, "phase", t, per_tok, 0, 0,
                          {"ms_per_token": round(per_tok * 1e3, 6)}))
        t += per_tok
    for kind, m in sorted(att.collectives.items()):
        per_tok = m.ms / max(att.tokens, 1) / 1e3
        spans.append(Span(kind, "collective", 0.0, per_tok, 1, 0,
                          {"count_per_token": m.count / max(att.tokens, 1),
                           "bytes_per_token":
                               (m.bytes or 0) / max(att.tokens, 1)}))
    doc = spans_to_chrome(spans)
    doc["traceEvents"].append({
        "name": "tracecheck", "ph": "M", "ts": 0, "pid": os.getpid(),
        "args": {"verdict": "OK" if report.ok else "DRIFT",
                 "label": report.label, "scheme": report.scheme,
                 "tp": report.n_slices,
                 "coverage": round(report.coverage, 4)}})
    return doc


def _check_bundle(path: str, emit_json: bool = False) -> int:
    """Validate + summarize a flight-recorder bundle (obs/flightrec).
    Exit 0 = loadable and schema-clean, 1 = damaged, 2 = unreadable."""
    from ..obs.flightrec import load_bundle

    try:
        bundle = load_bundle(path)
    except OSError as e:
        print(f"tracecheck: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"tracecheck: flight-recorder bundle {path} is invalid: "
              f"{e}", file=sys.stderr)
        return 1
    metric_lines = sum(1 for ln in bundle["metrics"].splitlines()
                       if ln and not ln.startswith("#"))
    summary = {
        "kind": bundle["kind"], "reason": bundle["reason"],
        # the watchtower detector that triggered an incident dump —
        # absent on watchdog/sigterm/crash-loop bundles
        "incident_kind": bundle.get("incident_kind"),
        "ts": bundle["ts"], "pid": bundle.get("pid"),
        "events": len(bundle["events"]), "spans": len(bundle["spans"]),
        "spans_dropped": bundle["spans_dropped"],
        "metric_samples": metric_lines,
        "journal_tail_records": len(bundle["journal_tail"]),
        # scheduler forensics — optional sections, so .get(): bundles
        # from older builds simply report 0
        "census_records": len(bundle.get("census_tail", [])),
        "open_ledgers": len(bundle.get("open_ledgers", [])),
        "config_keys": sorted(bundle["config"]),
    }
    if emit_json:
        print(json.dumps(summary))
    else:
        kind = (f" incident_kind={summary['incident_kind']}"
                if summary["incident_kind"] else "")
        print(f"flight-recorder bundle OK: reason={summary['reason']}"
              f"{kind} "
              f"events={summary['events']} spans={summary['spans']} "
              f"(+{summary['spans_dropped']} dropped) "
              f"metrics={summary['metric_samples']} samples "
              f"journal_tail={summary['journal_tail_records']} records "
              f"census={summary['census_records']} "
              f"open_ledgers={summary['open_ledgers']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tracecheck",
        description="per-step cost attribution + model-vs-measured drift "
                    "verdict over a profiler capture or trace fixture")
    ap.add_argument("capture", help="--profile dir / .pt.trace.json / "
                                    "dllama-trace fixture .json / "
                                    "flight-recorder bundle")
    ap.add_argument("--model", default=None,
                    help="7b|13b|70b|small, or the traced run's .bin "
                         "(its header gives the spec)")
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--scheme", default=None,
                    choices=("ref", "fused", "overlap"))
    ap.add_argument("--buffer", default=None, choices=("f32", "q80"))
    ap.add_argument("--tokens", type=int, default=0,
                    help="tokens decoded under the capture (fixtures "
                         "carry their own count; a Chrome trace counts "
                         "its forwards)")
    ap.add_argument("--chrome-out", default=None,
                    help="write the attribution as Chrome-trace JSON here")
    ap.add_argument("--json", action="store_true",
                    help="emit one machine-readable JSON object instead "
                         "of the table")
    args = ap.parse_args(argv)

    from ..obs.flightrec import is_bundle_file

    if is_bundle_file(args.capture):
        # a crash-forensics flight-recorder bundle: validate it and
        # summarize — exit 1 on schema damage (a postmortem
        # artifact discovered malformed mid-incident is worse than none)
        return _check_bundle(args.capture, emit_json=args.json)

    from ..obs.drift import reconcile_capture
    from ..obs.spans import validate_chrome_trace

    try:
        att, report = reconcile_capture(
            args.capture, model=args.model, tp=args.tp, scheme=args.scheme,
            buffer=args.buffer, tokens=args.tokens)
    except (OSError, ValueError) as e:
        print(f"tracecheck: {e}", file=sys.stderr)
        return 2

    if args.chrome_out:
        doc = attribution_chrome_trace(att, report)
        validate_chrome_trace(doc)  # never archive a malformed artifact
        os.makedirs(os.path.dirname(os.path.abspath(args.chrome_out)),
                    exist_ok=True)
        with open(args.chrome_out, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
            fh.write("\n")
        print(f"tracecheck: chrome trace -> {args.chrome_out}",
              file=sys.stderr)

    if args.json:
        out = report.to_json()
        out["phase_ms_per_token"] = att.phase_ms_per_token()
        print(json.dumps(out))
    else:
        print(report.render())
        print("phase ms/token: " + json.dumps(att.phase_ms_per_token()))
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
