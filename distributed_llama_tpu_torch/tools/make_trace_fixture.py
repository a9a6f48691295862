"""Generate synthetic capture fixtures for the drift observatory.

A fixture is a ``dllama-trace/1`` JSON file (obs/xprof.py) describing one
decode run's device events in aggregate: per-phase compute events plus one
event per collective kind whose count/bytes come EXACTLY from
``comm_stats.tp_collective_budget`` and whose time sits on the modeled
bandwidth+latency sum (``shard_sim.modeled_ici_ms``). Reconciling an
unmutated fixture therefore proves the whole attribute→reconcile pipeline
is a faithful join (every check lands OK by construction); the ``--mutate``
variants inject the failure the gate exists to catch:

  extra-collective   one all_gather/token more than the budget (the
                     "collective added without its model term" drift)
  inflate-bytes      +10% on the largest kind's bytes (accounting drift)
  unattributed       40% of compute time dropped out of named phases
                     (coverage drift)
  serialized-overlap overlap scheme only: ppermute events with ZERO
                     overlap_ns — the ring hops ran serialized against
                     compute, the exact regression the obs/drift overlap
                     check exists to catch (exit 1 in CI)

Unmutated overlap-scheme fixtures stamp each ppermute event with
``overlap_ns`` = 95% of its duration (the latency-hiding a healthy XLA
schedule shows); formats without per-event overlap timing make the check
SKIP, never vacuously pass.

The port's copy (of the top-level tools/make_trace_fixture.py) builds
fixtures from the port's budget and, by default, the card's link
constants (parallel/shard_sim.py); ``--write-all DIR`` writes the set the
repository's fixtures name into DIR (never into tests/fixtures/).

Usage:
  python3 -m distributed_llama_tpu_torch.tools.make_trace_fixture
      [--model 7b|13b|70b|small] [--tp N] [--scheme ref|fused|overlap]
      [--buffer f32|q80] [--tokens N] [--mutate KIND] [--out PATH]
  python3 -m distributed_llama_tpu_torch.tools.make_trace_fixture
      --write-all DIR
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# deterministic per-phase compute shares of the non-collective step time
# (loosely shaped like the 7B op-time split; values only need to be
# plausible and stable — the drift checks never read them as truth)
_PHASE_SHARES = {"embed": 0.01, "attn": 0.42, "ffn": 0.52, "logits": 0.05}


def build_fixture(model: str, tp: int, scheme: str, buffer: str = "f32",
                  tokens: int = 64, step_ms: float = 8.0,
                  mutate: str | None = None, gbps: float | None = None,
                  latency_us: float | None = None) -> dict:
    """One fixture. ``gbps`` and ``latency_us`` override the card's link
    constants (shard_sim's defaults) in the modelled collective time."""
    from ..obs.drift import spec_for
    from ..parallel.comm_stats import tp_collective_budget
    from ..parallel.shard_sim import modeled_ici_ms

    spec, _ = spec_for(model, buffer)
    budget = tp_collective_budget(spec, tp, scheme)
    kw = {k: v for k, v in (("gbps", gbps), ("latency_us", latency_us))
          if v is not None}
    bw_ms, lat_ms = modeled_ici_ms(spec, tp, scheme, **kw)
    coll_ms = bw_ms + lat_ms
    compute_ms = max(step_ms - coll_ms, 1.0)

    events = []
    for phase, share in _PHASE_SHARES.items():
        ms = compute_ms * share
        if mutate == "unattributed" and phase == "ffn":
            # drop a big slice of ffn time out of any named scope
            events.append({"name": "fusion.999", "scope": "",
                           "dur_ns": int(ms * 0.8 * 1e6 * tokens),
                           "occurrences": 2 * spec.n_layers * tokens})
            ms *= 0.2
        events.append({
            "name": f"fusion_{phase}", "scope": f"decode/layer/{phase}",
            "dur_ns": int(ms * 1e6 * tokens),
            "occurrences": max(spec.n_layers, 1) * tokens,
        })
    n_kinds = max(len(budget.entries), 1)
    for kind, count, moved_bytes in budget.entries:
        nbytes = moved_bytes
        if mutate == "inflate-bytes" and moved_bytes == max(
                b for _, _, b in budget.entries):
            nbytes = int(moved_bytes * 1.10)
        # collective events sit INSIDE the phase scopes they fire from;
        # per-kind time splits the modeled collective total evenly (only
        # the aggregate is held to the time band)
        ev = {
            "name": f"{kind}.1",
            "scope": f"decode/layer/attn/ici_{'psum_scatter' if kind == 'reduce_scatter' else kind}",
            "collective": kind,
            "dur_ns": int(coll_ms / n_kinds * 1e6 * tokens),
            "occurrences": count * tokens,
            "bytes": nbytes * tokens,
        }
        if scheme == "overlap" and kind == "ppermute":
            # latency-hiding census: how much of the ring-hop time ran
            # under concurrent compute (obs/drift overlap check). The
            # serialized mutation zeroes it — hops fully exposed.
            hidden = 0.0 if mutate == "serialized-overlap" else 0.95
            ev["overlap_ns"] = int(ev["dur_ns"] * hidden)
        events.append(ev)
    if mutate == "extra-collective":
        events.append({
            "name": "all_gather.rogue",
            "scope": "decode/layer/ffn/ici_all_gather",
            "collective": "all_gather",
            "dur_ns": int(0.05 * 1e6 * tokens),
            "occurrences": 1 * tokens,  # one extra launch per token
            "bytes": 4096 * tokens,
        })
    return {
        "schema": "dllama-trace/1",
        "config": {"model": model, "tp": tp, "scheme": scheme,
                   "buffer": buffer},
        "tokens": tokens,
        "note": ("synthetic capture generated by the port's "
                 "tools/make_trace_fixture.py from the analytic model"
                 + (f" (mutated: {mutate})" if mutate else "")),
        "events": events,
    }


# the set tests/fixtures/traces/ holds: all three schemes at 7B/13B, one
# mutated fixture per failure class
CHECKED_IN = [
    ("trace_7b_tp8_ref.json", dict(model="7b", tp=8, scheme="ref")),
    ("trace_7b_tp8_fused.json", dict(model="7b", tp=8, scheme="fused")),
    ("trace_7b_tp8_overlap.json", dict(model="7b", tp=8, scheme="overlap")),
    ("trace_13b_tp8_ref.json", dict(model="13b", tp=8, scheme="ref")),
    ("trace_13b_tp8_fused.json", dict(model="13b", tp=8, scheme="fused")),
    ("trace_13b_tp8_overlap.json",
     dict(model="13b", tp=8, scheme="overlap")),
    ("trace_7b_tp8_ref_extra_collective.json",
     dict(model="7b", tp=8, scheme="ref", mutate="extra-collective")),
    ("trace_7b_tp8_fused_inflate_bytes.json",
     dict(model="7b", tp=8, scheme="fused", mutate="inflate-bytes")),
    ("trace_7b_tp8_ref_unattributed.json",
     dict(model="7b", tp=8, scheme="ref", mutate="unattributed")),
    ("trace_7b_tp8_overlap_serialized.json",
     dict(model="7b", tp=8, scheme="overlap",
          mutate="serialized-overlap")),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="make_trace_fixture",
        description="generate dllama-trace/1 synthetic capture fixtures")
    ap.add_argument("--model", default="7b",
                    choices=("7b", "13b", "70b", "small"))
    ap.add_argument("--tp", type=int, default=8)
    ap.add_argument("--scheme", default="ref",
                    choices=("ref", "fused", "overlap"))
    ap.add_argument("--buffer", default="f32", choices=("f32", "q80"))
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--mutate", default=None,
                    choices=("extra-collective", "inflate-bytes",
                             "unattributed", "serialized-overlap"))
    ap.add_argument("--out", default=None, help="output path (default "
                    "stdout)")
    ap.add_argument("--write-all", default=None, metavar="DIR",
                    help="write the whole set (CHECKED_IN's names) into "
                         "DIR")
    args = ap.parse_args(argv)
    if args.write_all:
        os.makedirs(args.write_all, exist_ok=True)
        for fname, kw in CHECKED_IN:
            path = os.path.join(args.write_all, fname)
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(build_fixture(**kw), fh, indent=1)
                fh.write("\n")
            print(f"wrote {path}")
        return 0
    doc = build_fixture(args.model, args.tp, args.scheme, args.buffer,
                        args.tokens, mutate=args.mutate)
    text = json.dumps(doc, indent=1) + "\n"
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(text)
        print(f"wrote {args.out}")
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
