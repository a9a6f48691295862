"""The port's wire formats against the golden corpus (tests/fixtures/wire/,
written by tools/make_wire_corpus.py through the JAX package's producers):

* the port's producers repeat the corpus generator's v2 call sequences and
  give the committed v2 ``journal.wal``, ``metrics.prom``, ``bundle.json``
  and ``fingerprint.json`` byte for byte (and v1's fingerprint and
  metrics, which the current producers also give);
* the port's readers read every v1 and v2 journal, metrics and health
  sample to its ``expect.json`` (the pins tools/wirecheck.py holds the
  JAX readers to), and its flight-recorder validator accepts both
  bundles;
* ``tracectx.parse_header`` reads ``traceparent/v1/header.txt`` and a
  seeded mint writes it again.

The handoff and page-wire formats (prefill/decode disaggregation) are
held in tests/test_torch_pagewire.py.
"""

import json
import os
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
WIRE = ROOT / "tests" / "fixtures" / "wire"
sys.path.insert(0, str(ROOT / "tools"))

import make_wire_corpus as corpus  # noqa: E402  (its SPEC and call data)


def _read(*parts, binary=False):
    p = WIRE.joinpath(*parts)
    return p.read_bytes() if binary else p.read_text(encoding="utf-8")


def _expect(*parts):
    return json.loads(_read(*parts))


def _json_file(obj) -> str:
    """The generator's JSON file encoding."""
    return json.dumps(obj, indent=2, sort_keys=True) + "\n"


def _fingerprint(era):
    from distributed_llama_tpu_torch.runtime.journal import \
        config_fingerprint

    if era == "v1":
        return config_fingerprint(corpus.SPEC, "ring", "per_request")
    return config_fingerprint(corpus.SPEC, "ring", "per_request",
                              weights_digest="d" * 16, kv_quant="q8",
                              kv_cache_dtype="q8", kv_host_pages=8,
                              kv_disk=True)


def _metrics(era) -> str:
    from distributed_llama_tpu_torch.obs.metrics import Registry

    reg = Registry()
    reg.counter("dllama_requests_total", "requests retired").inc(4)
    reg.counter("dllama_generated_tokens_total", "tokens sampled").inc(64)
    reg.counter("dllama_prefix_hits_total", "prefix cache hits").inc(5)
    reg.gauge("dllama_kv_pages_free", "free kv pages").set(17)
    reg.gauge("dllama_queue_depth", "queued requests").set(3)
    reg.labeled_counter("dllama_goodput_tokens_total",
                        {"class": "interactive"}, "slo-met tokens").inc(72)
    if era == "v2":
        reg.labeled_counter("dllama_page_seconds_total",
                            {"class": "interactive"},
                            "page-held seconds").inc(0.25)
        reg.labeled_counter("dllama_stall_seconds_total",
                            {"cause": "page_wait"}, "stall seconds").inc(
            0.125)
    return reg.expose()


@pytest.mark.parametrize("era", ["v1", "v2"])
def test_fingerprint_file_is_reproduced(era):
    assert _json_file(_fingerprint(era)) == _read("fingerprint", era,
                                                  "fingerprint.json")


@pytest.mark.parametrize("era", ["v1", "v2"])
def test_metrics_exposition_is_reproduced(era):
    assert _metrics(era) == _read("metrics", era, "metrics.prom")


def test_journal_v2_is_reproduced(tmp_path):
    from distributed_llama_tpu_torch.obs import tracectx
    from distributed_llama_tpu_torch.runtime.journal import RequestJournal

    path = str(tmp_path / "journal.wal")
    tracectx.seed_ids(1234)
    try:
        j = RequestJournal(path, fsync="off", config=_fingerprint("v2"))
        j.admit(1, [1, 5, 9], 8, 0.8, 0.9, 11, slo="interactive",
                trace=tracectx.mint().to_header())
        j.token(1, 17, 1)
        j.admit(2, [2, 4], 6, 0.7, 0.95, 12, slo="batch",
                trace=tracectx.mint().to_header(),
                ledger={"tokens": 3, "page_steps": 4, "compute_s": 0.5})
        j.retire(2, "done")
        j.admit(3, [1, 5, 9], 8, 0.8, 0.9, 11, slo="interactive",
                cursor=1, recovers=1, trace=tracectx.mint().to_header())
        j.token(3, 29, 2)
        j.close()
    finally:
        tracectx.seed_ids(None)
    with open(path, "rb") as f:
        assert f.read() == _read("journal", "v2", "journal.wal",
                                 binary=True)


def test_bundle_v2_is_reproduced():
    from distributed_llama_tpu_torch.obs.flightrec import (BUNDLE_KIND,
                                                           BUNDLE_VERSION)

    journal_tail = [{"t": "admit", "id": 1, "tokens": [1, 5, 9],
                     "steps": 8, "temperature": 0.8, "topp": 0.9,
                     "seed": 11, "slo": None, "cursor": 0}]
    bundle = {
        "kind": BUNDLE_KIND, "version": BUNDLE_VERSION,
        "reason": "incident", "ts": 1700000000.0, "pid": 4242,
        "stamp": {"tp_scheme": "ring"}, "config": _fingerprint("v2"),
        "events": [{"ts": 1.0, "event": "watchdog.trip"}],
        "spans": [{"span": "decode.step", "cat": "engine",
                   "t_start_s": 0.5, "dur_ms": 2.25, "tid": 1,
                   "depth": 0}],
        "spans_dropped": 0, "metrics": _metrics("v2"),
        "journal_tail": journal_tail,
        "census_tail": [{"step": 100, "prefill": 1, "decode": 2,
                         "stalled": 0}],
        "open_ledgers": [{"id": 3, "tokens": 1, "page_steps": 4}],
        "incident_kind": "page_leak"}
    assert _json_file(bundle) == _read("bundle", "v2", "bundle.json")


@pytest.mark.parametrize("era", ["v1", "v2"])
def test_journal_is_read_to_expect(era):
    from distributed_llama_tpu_torch.runtime.journal import (_load_file,
                                                             load_journal)

    wal = str(WIRE / "journal" / era / "journal.wal")
    exp = _expect("journal", era, "expect.json")
    entries = load_journal(wal)
    by_rid = {e.rid: e for e in entries}
    assert sorted(e.rid for e in entries if e.status is None) \
        == exp["live_rids"]
    for rid, status in exp["retired"].items():
        assert by_rid[int(rid)].status == status
    for rid, sampled in exp.get("sampled", {}).items():
        assert by_rid[int(rid)].sampled == sampled
    for rid, cur in exp.get("cursor", {}).items():
        assert by_rid[int(rid)].cursor == cur
    for rid, tr in exp.get("trace", {}).items():
        assert by_rid[int(rid)].trace == tr
    for rid in exp.get("has_trace", ()):
        assert isinstance(by_rid[int(rid)].trace, str)
    for rid in exp.get("ledger_rids", ()):
        assert isinstance(by_rid[int(rid)].ledger, dict)
    header = _load_file(wal)[2]
    assert header == (None if era == "v1" else _fingerprint("v2"))


@pytest.mark.parametrize("era", ["v1", "v2"])
def test_metrics_are_read_to_expect(era):
    from distributed_llama_tpu_torch.obs.fleet import (ReplicaSignals,
                                                       apply_metrics,
                                                       parse_metrics)

    exp = _expect("metrics", era, "expect.json")
    row = ReplicaSignals(name="corpus")
    row.present = set()
    apply_metrics(row, parse_metrics(_read("metrics", era, "metrics.prom")))
    for key in ("prefix_hits", "kv_pages_free", "queue_depth",
                "goodput_tokens", "page_seconds", "stall_seconds"):
        assert getattr(row, key) == exp[key], key


@pytest.mark.parametrize("era", ["v1", "v2"])
def test_health_is_read_to_expect(era):
    from distributed_llama_tpu_torch.obs.fleet import signals_from_health

    exp = _expect("health", era, "expect.json")
    row = signals_from_health("corpus", _expect("health", era,
                                                "health.json"))
    assert row.schema == exp["schema"]
    assert sorted(row.present or ()) == exp["present"]
    for key in ("healthy", "kv_pages", "kv_pages_free", "prefix_hits",
                "prefix_misses", "prefill_tokens_saved", "goodput_tokens",
                "page_seconds", "stall_seconds", "queue_depth",
                "occupancy"):
        assert getattr(row, key) == exp[key], key
    if "cost_interactive_tokens" in exp:
        assert row.cost_classes["interactive"]["tokens"] \
            == exp["cost_interactive_tokens"]


@pytest.mark.parametrize("era", ["v1", "v2"])
def test_bundles_pass_the_port_validator(era):
    from distributed_llama_tpu_torch.obs.flightrec import (is_bundle_file,
                                                           load_bundle)

    path = str(WIRE / "bundle" / era / "bundle.json")
    assert is_bundle_file(path)
    assert load_bundle(path)["kind"]


def test_traceparent_header_round_trips():
    from distributed_llama_tpu_torch.obs import tracectx

    header = _read("traceparent", "v1", "header.txt")
    ctx = tracectx.parse_header(header)
    assert ctx.to_header() == header
    tracectx.seed_ids(99)
    try:
        assert tracectx.mint().to_header() == header
    finally:
        tracectx.seed_ids(None)
    assert os.path.basename(str(WIRE)) == "wire"
