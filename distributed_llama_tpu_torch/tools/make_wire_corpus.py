"""Write the golden wire corpus (tests/fixtures/wire/) through the port's
producers (the port's copy of the top-level tools/make_wire_corpus.py).

Two eras per versioned format:
  v1   the legacy era: handcrafted bytes in the shape an N-1 build wrote
       (no trace/ledger journal records, no ``schema`` health key, no
       cost-accounting metric families); current readers must read them
       (tools/wirecheck.py's skew matrix);
  v2   the current era: written through the port's producers
       (RequestJournal, entry_to_wire, pagewire.encode_record,
       obs.metrics.Registry), so a rerun is the byte-determinism gate: the
       files equal the committed corpus byte for byte, which the JAX
       package's generator wrote.

Every sample is deterministic: fixed ids (obs.tracectx.seed_ids), fixed
timestamps, no wall clock. ``expect.json`` beside each sample pins what
the readers must extract. The corpus README.md names the JAX package's
registry and is not rewritten here.

Usage:
    python -m distributed_llama_tpu_torch.tools.make_wire_corpus --out DIR

``--out`` has no default: the committed corpus is the JAX generator's,
and a run of this one is compared against it (tests/
test_torch_analysis_wirecheck.py), not written over it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace

from ..obs import tracectx
from ..obs.flightrec import BUNDLE_KIND, BUNDLE_VERSION
from ..obs.metrics import Registry
from ..runtime.journal import (JournalEntry, RequestJournal,
                               config_fingerprint, entry_to_wire)
from ..runtime.pagewire import encode_record

# The smoke-model spec every corpus fingerprint is derived from (the JAX
# generator's).
SPEC = SimpleNamespace(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                       n_kv_heads=2, vocab_size=128, seq_len=32,
                       weights_float_type=2, buffer_float_type=0)

_TS = 1700000000.0  # fixed corpus timestamp — no wall clock anywhere


def _dumps(obj) -> bytes:
    """Compact JSON, exactly the journal/_append wire encoding."""
    return json.dumps(obj, separators=(",", ":")).encode("utf-8")


# ---------------------------------------------------------------- config
def build_fingerprint_v1() -> dict:
    """The fingerprint an N−1 build journaled: pre-kv-tier keys only
    (kv_quant and friends are omitted-when-default, so a legacy header
    and a current default-config header are byte-identical)."""
    return config_fingerprint(SPEC, "ring", "per_request")


def build_fingerprint_v2() -> dict:
    """A current-era fingerprint exercising every conditional key."""
    return config_fingerprint(SPEC, "ring", "per_request",
                              weights_digest="d" * 16, kv_quant="q8",
                              kv_cache_dtype="q8", kv_host_pages=8,
                              kv_disk=True)


# --------------------------------------------------------------- journal
def build_journal_v1() -> bytes:
    """A legacy WAL, byte-for-byte what a pre-trace/pre-ledger build
    wrote: header without config, admit records without trace/ledger
    (one even omits slo+cursor — older still). Live state after replay:
    rid 1 mid-flight with two sampled tokens, rid 2 untouched, rid 3
    retired."""
    lines = [
        {"t": "journal", "v": 1},
        {"t": "admit", "id": 1, "tokens": [1, 5, 9], "steps": 8,
         "temperature": 0.8, "topp": 0.9, "seed": 11, "slo": None,
         "cursor": 0},
        {"t": "tok", "id": 1, "tok": 17, "cursor": 1},
        {"t": "tok", "id": 1, "tok": 23, "cursor": 2},
        {"t": "admit", "id": 2, "tokens": [2, 4], "steps": 6,
         "temperature": 0.7, "topp": 0.95, "seed": 12},
        {"t": "admit", "id": 3, "tokens": [3], "steps": 4,
         "temperature": 0.0, "topp": 1.0, "seed": 13, "slo": "batch",
         "cursor": 0},
        {"t": "retire", "id": 3, "status": "done"},
    ]
    return b"".join(_dumps(rec) + b"\n" for rec in lines)


def build_journal_v2(path: str) -> None:
    """A current-era WAL written THROUGH RequestJournal: config header,
    traced admits, a carried ledger, and a recovery re-admission
    (admit recovers=1). Deterministic via seeded trace ids."""
    tracectx.seed_ids(1234)
    try:
        j = RequestJournal(path, fsync="off",
                           config=build_fingerprint_v2())
        j.admit(1, [1, 5, 9], 8, 0.8, 0.9, 11, slo="interactive",
                trace=tracectx.mint().to_header())
        j.token(1, 17, 1)
        j.admit(2, [2, 4], 6, 0.7, 0.95, 12, slo="batch",
                trace=tracectx.mint().to_header(),
                ledger={"tokens": 3, "page_steps": 4,
                        "compute_s": 0.5})
        j.retire(2, "done")
        j.admit(3, [1, 5, 9], 8, 0.8, 0.9, 11, slo="interactive",
                cursor=1, recovers=1,
                trace=tracectx.mint().to_header())
        j.token(3, 29, 2)
        j.close()
    finally:
        tracectx.seed_ids(None)


JOURNAL_V1_EXPECT = {
    "live_rids": [1, 2],
    "retired": {"3": "done"},
    "sampled": {"1": [17, 23], "2": []},
    "cursor": {"1": 2, "2": 0},
    "trace": {"1": None, "2": None},
    "header_config": None,
}

JOURNAL_V2_EXPECT = {
    "live_rids": [3],
    "retired": {"1": "recovered", "2": "done"},
    "sampled": {"3": [29]},
    "cursor": {"3": 2},
    "has_trace": [1, 2, 3],
    "ledger_rids": [2],
}


# --------------------------------------------------------------- handoff
def build_handoff_v1() -> bytes:
    """A legacy disagg handoff record: no trace, no ledger keys at all
    (the N−1 prefill pool never minted them)."""
    return _dumps({"id": 7, "tokens": [3, 1, 4], "sampled": [15],
                   "cursor": 1, "steps": 6, "temperature": 0.7,
                   "topp": 0.95, "seed": 21, "slo": "interactive"})


def build_handoff_v2() -> bytes:
    """A current handoff record through the real codec (entry_to_wire)
    with every optional field populated. entry_from_wire∘entry_to_wire
    must be byte-identity on this sample (skew matrix checks it)."""
    tracectx.seed_ids(77)
    try:
        entry = JournalEntry(
            rid=7, tokens=[3, 1, 4], steps=6, temperature=0.7,
            topp=0.95, seed=21, slo="interactive", cursor=1,
            sampled=[15], trace=tracectx.mint().to_header(),
            ledger={"tokens": 1, "page_steps": 4, "compute_s": 0.25})
    finally:
        tracectx.seed_ids(None)
    return _dumps(entry_to_wire(entry))


HANDOFF_V1_EXPECT = {"rid": 7, "replay_tokens": [3, 1, 4, 15],
                     "cursor": 1, "trace": None, "ledger": None}
HANDOFF_V2_EXPECT = {"rid": 7, "replay_tokens": [3, 1, 4, 15],
                     "cursor": 1, "has_trace": True,
                     "ledger_tokens": 1}


# -------------------------------------------------------------- pagewire
def _f32_planes():
    import numpy as np
    k = (np.arange(64, dtype=np.float32).reshape(2, 4, 8) * 0.5 - 3.0)
    v = (np.arange(64, dtype=np.float32).reshape(2, 4, 8) * 0.25 + 1.0)
    return (k, v)


def _q8_planes():
    import numpy as np
    kq = ((np.arange(64) % 127) - 63).astype(np.int8).reshape(2, 4, 8)
    kd = (np.arange(8, dtype=np.float32) + 1.0).reshape(2, 4, 1)
    vq = ((np.arange(64) % 101) - 50).astype(np.int8).reshape(2, 4, 8)
    vd = (np.arange(8, dtype=np.float32) * 0.125 + 0.5).reshape(2, 4, 1)
    return (kq, kd, vq, vd)


def build_pagewire_f32() -> bytes:
    """One framed f32 page record through the real codec."""
    return encode_record(_f32_planes())


def build_pagewire_q8() -> bytes:
    """One framed Q8 page record (quant + dequant-scale planes)."""
    return encode_record(_q8_planes())


PAGEWIRE_EXPECT = {
    "f32": {"n_planes": 2, "shapes": [[2, 4, 8], [2, 4, 8]],
            "dtypes": ["<f4", "<f4"], "payload_bytes": 512},
    "q8": {"n_planes": 4,
           "shapes": [[2, 4, 8], [2, 4, 1], [2, 4, 8], [2, 4, 1]],
           "dtypes": ["|i1", "<f4", "|i1", "<f4"],
           "payload_bytes": 192},
}


# ---------------------------------------------------------------- health
def build_health_v1() -> dict:
    """An N−1 /health payload: no ``schema`` key, no sched/speculative/
    kv_tiers/disagg blocks — the surface a pre-ledger replica exposed."""
    return {
        "state": "serving", "active": 1, "queued": 2, "queue_depth": 2,
        "slots": 4, "steps": 100, "generated_tokens": 64,
        "uptime_s": 12.5, "occupancy": 0.25, "pauses": 0,
        "requeues": 0,
        "paged_kv": {"pages": 24, "pages_free": 17, "page_size": 4,
                     "prefix_hits": 5, "prefix_misses": 2,
                     "prefill_tokens_saved": 12},
        "slo": {"classes": {"interactive": {
            "attempted": 3, "met": 2, "violated": 1, "failed": 0,
            "goodput_tokens": 40}}},
    }


def build_health_v2() -> dict:
    """A current /health payload: schema stamp plus every conditional
    block present, so the fleet row's presence set is exercised end to
    end."""
    return {
        "schema": 3,
        "state": "serving", "active": 1, "queued": 2, "queue_depth": 2,
        "slots": 4, "steps": 100, "generated_tokens": 64,
        "uptime_s": 12.5, "occupancy": 0.25, "pauses": 0,
        "requeues": 0,
        "paged_kv": {"pages": 24, "pages_free": 17, "page_size": 4,
                     "prefix_hits": 5, "prefix_misses": 2,
                     "prefill_tokens_saved": 12},
        "kv_tiers": {"host_pages": 8, "disk_pages": 0,
                     "swap_in": 3, "swap_out": 4},
        "disagg": {"role": "decode", "handoffs": {"local": 1,
                                                  "shipped": 2,
                                                  "failed": 0}},
        "journal": {"records": 9, "live": 1, "compactions": 0},
        "watchdog": {"trips": 0, "last_trip_s": None},
        "slo": {"classes": {
            "interactive": {"attempted": 3, "met": 2, "violated": 1,
                            "failed": 0, "goodput_tokens": 40},
            "batch": {"attempted": 1, "met": 1, "violated": 0,
                      "failed": 0, "goodput_tokens": 30}}},
        "sched": {
            "census": {"prefill": 1, "decode": 2, "stalled": 0},
            "cost_totals": {"page_s": 0.25,
                            "stall_s": {"page_wait": 0.125}},
            "cost_by_class": {"interactive": {
                "tokens": 40, "requests": 3, "compute_s": 0.5,
                "page_s": 0.25, "stall_s_total": 0.125,
                "page_steps": 6}}},
        "speculative": {"draft_len": 0, "accepted": 0, "rejected": 0},
        "watch": {"ticks": 12, "incidents_total": 1,
                  "incidents": {"page_leak": 1},
                  "detectors": {"page_leak": "firing",
                                "slo_burn": "ok"},
                  "last_incident": {"seq": 0, "kind": "page_leak",
                                    "replica": "self", "tick": 9,
                                    "note": "idle pages_free 20->18"}},
    }


HEALTH_V1_EXPECT = {
    "schema": 0, "present": ["paged_kv", "slo"], "healthy": True,
    "kv_pages": 24, "kv_pages_free": 17, "prefix_hits": 5,
    "prefix_misses": 2, "prefill_tokens_saved": 12,
    "goodput_tokens": 40, "page_seconds": 0.0, "stall_seconds": {},
    "queue_depth": 2, "occupancy": 0.25,
}

HEALTH_V2_EXPECT = {
    "schema": 3,
    "present": ["disagg", "journal", "kv_tiers", "paged_kv", "sched",
                "slo", "speculative", "watchdog"],
    "healthy": True, "kv_pages": 24, "kv_pages_free": 17,
    "prefix_hits": 5, "prefix_misses": 2, "prefill_tokens_saved": 12,
    "goodput_tokens": 70, "page_seconds": 0.25,
    "stall_seconds": {"page_wait": 0.125},
    "queue_depth": 2, "occupancy": 0.25,
    "cost_interactive_tokens": 40,
}


# --------------------------------------------------------------- metrics
def build_metrics_v1() -> str:
    """An N−1 /metrics exposition through the real Registry: the
    families from before the cost accounting only (no page/stall cost
    counters)."""
    reg = Registry()
    reg.counter("dllama_requests_total", "requests retired").inc(4)
    reg.counter("dllama_generated_tokens_total",
                "tokens sampled").inc(64)
    reg.counter("dllama_prefix_hits_total", "prefix cache hits").inc(5)
    reg.gauge("dllama_kv_pages_free", "free kv pages").set(17)
    reg.gauge("dllama_queue_depth", "queued requests").set(3)
    reg.labeled_counter("dllama_goodput_tokens_total",
                        {"class": "interactive"},
                        "slo-met tokens").inc(72)
    return reg.expose()


def build_metrics_v2() -> str:
    """A current /metrics exposition: the v1 families plus the
    cost-accounting families the fleet plane cross-fills from."""
    reg = Registry()
    reg.counter("dllama_requests_total", "requests retired").inc(4)
    reg.counter("dllama_generated_tokens_total",
                "tokens sampled").inc(64)
    reg.counter("dllama_prefix_hits_total", "prefix cache hits").inc(5)
    reg.gauge("dllama_kv_pages_free", "free kv pages").set(17)
    reg.gauge("dllama_queue_depth", "queued requests").set(3)
    reg.labeled_counter("dllama_goodput_tokens_total",
                        {"class": "interactive"},
                        "slo-met tokens").inc(72)
    reg.labeled_counter("dllama_page_seconds_total",
                        {"class": "interactive"},
                        "page-held seconds").inc(0.25)
    reg.labeled_counter("dllama_stall_seconds_total",
                        {"cause": "page_wait"},
                        "stall seconds").inc(0.125)
    return reg.expose()


METRICS_V1_EXPECT = {
    "prefix_hits": 5, "kv_pages_free": 17, "queue_depth": 3,
    "goodput_tokens": 72, "page_seconds": 0.0, "stall_seconds": {},
}
METRICS_V2_EXPECT = {
    "prefix_hits": 5, "kv_pages_free": 17, "queue_depth": 3,
    "goodput_tokens": 72, "page_seconds": 0.25,
    "stall_seconds": {"page_wait": 0.125},
}


# ---------------------------------------------------------------- bundle
def build_bundle_v1() -> dict:
    """A legacy flight-recorder bundle: the original required sections
    only (no census_tail / open_ledgers). validate_bundle must accept
    it forever — crash evidence does not expire."""
    return {
        "kind": BUNDLE_KIND, "version": BUNDLE_VERSION,
        "reason": "corpus", "ts": _TS, "pid": 4242,
        "stamp": {"tp_scheme": "ring"},
        "config": build_fingerprint_v1(),
        "events": [{"ts": 1.0, "event": "watchdog.trip"}],
        "spans": [{"span": "decode.step", "cat": "engine",
                   "t_start_s": 0.5, "dur_ms": 2.25, "tid": 1,
                   "depth": 0}],
        "spans_dropped": 0,
        "metrics": build_metrics_v1(),
        "journal_tail": [{"t": "admit", "id": 1, "tokens": [1, 5, 9],
                          "steps": 8, "temperature": 0.8, "topp": 0.9,
                          "seed": 11, "slo": None, "cursor": 0}],
    }


def build_bundle_v2() -> dict:
    """A current bundle: v1 sections plus the census and ledger
    tails and the incident header stamp."""
    out = build_bundle_v1()
    out["config"] = build_fingerprint_v2()
    out["metrics"] = build_metrics_v2()
    out["census_tail"] = [{"step": 100, "prefill": 1, "decode": 2,
                           "stalled": 0}]
    out["open_ledgers"] = [{"id": 3, "tokens": 1, "page_steps": 4}]
    out["reason"] = "incident"
    out["incident_kind"] = "page_leak"
    return out


# ----------------------------------------------------------- traceparent
def build_traceparent() -> str:
    tracectx.seed_ids(99)
    try:
        return tracectx.mint().to_header()
    finally:
        tracectx.seed_ids(None)


# ----------------------------------------------------------------- write
def _write(path: str, data) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if isinstance(data, bytes):
        with open(path, "wb") as f:
            f.write(data)
    else:
        with open(path, "w", encoding="utf-8") as f:
            f.write(data)


def _write_json(path: str, obj) -> None:
    _write(path, json.dumps(obj, indent=2, sort_keys=True) + "\n")


def write_corpus(out_dir: str) -> list:
    """Write every corpus file under ``out_dir``; returns the relative
    paths written (sorted), for manifests and byte-compare gates."""
    j = os.path.join
    _write_json(j(out_dir, "fingerprint", "v1", "fingerprint.json"),
                build_fingerprint_v1())
    _write_json(j(out_dir, "fingerprint", "v2", "fingerprint.json"),
                build_fingerprint_v2())

    _write(j(out_dir, "journal", "v1", "journal.wal"),
           build_journal_v1())
    _write_json(j(out_dir, "journal", "v1", "expect.json"),
                JOURNAL_V1_EXPECT)
    v2_wal = j(out_dir, "journal", "v2", "journal.wal")
    os.makedirs(os.path.dirname(v2_wal), exist_ok=True)
    if os.path.exists(v2_wal):
        os.unlink(v2_wal)  # RequestJournal appends to existing files
    build_journal_v2(v2_wal)
    _write_json(j(out_dir, "journal", "v2", "expect.json"),
                JOURNAL_V2_EXPECT)

    _write(j(out_dir, "handoff", "v1", "record.json"),
           build_handoff_v1())
    _write_json(j(out_dir, "handoff", "v1", "expect.json"),
                HANDOFF_V1_EXPECT)
    _write(j(out_dir, "handoff", "v2", "record.json"),
           build_handoff_v2())
    _write_json(j(out_dir, "handoff", "v2", "expect.json"),
                HANDOFF_V2_EXPECT)

    _write(j(out_dir, "pagewire", "v1", "f32.bin"),
           build_pagewire_f32())
    _write(j(out_dir, "pagewire", "v1", "q8.bin"),
           build_pagewire_q8())
    _write_json(j(out_dir, "pagewire", "v1", "expect.json"),
                PAGEWIRE_EXPECT)

    _write_json(j(out_dir, "health", "v1", "health.json"),
                build_health_v1())
    _write_json(j(out_dir, "health", "v1", "expect.json"),
                HEALTH_V1_EXPECT)
    _write_json(j(out_dir, "health", "v2", "health.json"),
                build_health_v2())
    _write_json(j(out_dir, "health", "v2", "expect.json"),
                HEALTH_V2_EXPECT)

    _write(j(out_dir, "metrics", "v1", "metrics.prom"),
           build_metrics_v1())
    _write_json(j(out_dir, "metrics", "v1", "expect.json"),
                METRICS_V1_EXPECT)
    _write(j(out_dir, "metrics", "v2", "metrics.prom"),
           build_metrics_v2())
    _write_json(j(out_dir, "metrics", "v2", "expect.json"),
                METRICS_V2_EXPECT)

    _write_json(j(out_dir, "bundle", "v1", "bundle.json"),
                build_bundle_v1())
    _write_json(j(out_dir, "bundle", "v2", "bundle.json"),
                build_bundle_v2())

    _write(j(out_dir, "traceparent", "v1", "header.txt"),
           build_traceparent())

    rels = []
    for root, _dirs, files in os.walk(out_dir):
        for fn in files:
            rels.append(os.path.relpath(os.path.join(root, fn),
                                        out_dir))
    return sorted(r for r in rels if r != "README.md")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="corpus directory to write")
    args = ap.parse_args(argv)
    written = write_corpus(args.out)
    print(f"wire corpus: {len(written)} file(s) under {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
