"""The port's books (obs/*, utils/fingerprint.py) against the JAX
package's, call for call on the CPU: for the same calls each gives the
same bytes or the same object —

* the metrics registry's Prometheus exposition (counters, gauges,
  histograms, labeled series, the engine metrics' full set);
* the request ledgers and the ledger book, the census ring's ``to_json``;
* the span tracer's Chrome and NDJSON exports (the JAX
  validate_chrome_trace accepts the port's) and its ring overflow count;
* trace-context headers under ``seed_ids``, children and links;
* the SLO policy's parse and its tracker's snapshot;
* the watchtower's incidents over a sample sequence, and fleet rows;
* ``--log-json`` lines (the same stamp keys) and the text mode.
"""

import importlib
import io
import json

import pytest


def _both(module):
    return (importlib.import_module(f"distributed_llama_tpu.{module}"),
            importlib.import_module(f"distributed_llama_tpu_torch.{module}"))


def _registry_calls(metrics):
    reg = metrics.Registry()
    reg.counter("dllama_a_total", "a counter").inc(3)
    g = reg.gauge("dllama_b", "a gauge")
    g.set(7.5)
    g.dec(0.25)
    h = reg.histogram("dllama_c_seconds", "a histogram")
    for v in (0.0001, 0.003, 0.2, 1.5, 99.0):
        h.observe(v)
    reg.labeled_counter("dllama_d_total", {"kind": "x"}, "labeled").inc(2)
    reg.labeled_counter("dllama_d_total", {"kind": "y"}, "labeled").inc()
    reg.labeled_gauge("dllama_e", {"class": 'q"uote'}, "labeled g").set(1)
    reg.labeled_histogram("dllama_f_seconds", {"class": "i"}, "lh",
                          buckets=(0.1, 1.0)).observe(0.5)
    return reg, h


def test_registry_exposition_is_jax_bytes():
    jm, pm = _both("obs.metrics")
    (jr, jh), (pr, ph) = _registry_calls(jm), _registry_calls(pm)
    assert pr.expose() == jr.expose()
    assert ph.summary() == jh.summary()
    assert (pm.summarize_values([3.0, 1.0, 2.0, 9.0])
            == jm.summarize_values([3.0, 1.0, 2.0, 9.0]))


def test_engine_metrics_expose_the_jax_set():
    jm, pm = _both("obs.metrics")
    jt, pt = _both("obs.trace")
    out = []
    for metrics, trace in ((jm, jt), (pm, pt)):
        reg = metrics.Registry()
        em = trace.EngineMetrics(reg)
        em.bind_kv_pool("q8", 4096, 9)
        em.record_step(0.004, 3, steps=2)
        em.reject("oversized")
        em.add_stall_seconds("pool_dry", 0.5)
        em.add_page_seconds("interactive", 0.25)
        em.count_dispatch_tokens("spec", 3)
        em.set_class_queue_depth({"batch": 2})
        out.append(reg.expose())
    assert out[1] == out[0]


def _ledger_calls(ledger):
    book = ledger.LedgerBook()
    a = book.open_request(0, "interactive")
    a.charge_rows(4, 0.01)
    a.charge_tokens(5)
    a.charge_prefill(2, 8, 0.02)
    a.charge_pages(3, 4, 0.01)
    a.charge_stall("pool_dry", 2, 0.01)
    a.charge_spec(3, 2)
    b = book.open_request(1, "batch", carried={"tokens": 4,
                                               "page_steps": 2})
    b.charge_stall("queue_wait", 1, 0.5)
    b.charge_ici(1024.0)
    book.close_request(0, "done")
    ring = ledger.CensusRing(4)
    ring.record("decode", 2, 3, {"pool_dry": 1}, 2, 7)
    ring.record("prefill", 0, 0, {}, 0, 0, prefill_tokens=9)
    ring.record("mixed", 1, 2, {"budget_wait": 1}, 0, 5)
    ring.count_tokens("decode", 4)
    ring.count_tokens("spec", 2)
    closed = [{k: v for k, v in s.items() if k != "t_closed"}
              for s in book.closed_tail()]
    return (book.grand_totals(), book.class_rollup(), book.open_snapshots(),
            closed, (book.opened_n, book.closed_n, book.n_open),
            ring.to_json(tail=8), ring.totals())


def test_ledgers_and_census_are_jax_objects():
    jl, pl = _both("obs.ledger")
    assert _ledger_calls(pl) == _ledger_calls(jl)
    assert pl.STALL_CAUSES == jl.STALL_CAUSES
    assert pl.TOKEN_KINDS == jl.TOKEN_KINDS


def _span_calls(spans, tracectx):
    tracectx.seed_ids(7)
    try:
        tr = spans.SpanTracer(capacity=3)
        tr.epoch = 9.0  # the export is relative to it
        ctx = tracectx.mint()
        tr.add("request", "request", 10.0, 0.5, index=0,
               **tracectx.span_fields(ctx))
        tr.add("step", "decode", 10.1, 0.01, active=2)
        tr.add("prefill", "prefill", 10.2, 0.02, slot=1, tokens=8)
        tr.add("chain", "decode", 10.3, 0.04, steps=4)  # overflows
        return (tr.export_chrome(), tr.export_ndjson(),
                tr.export_chrome(ctx.trace_id), tr.dropped)
    finally:
        tracectx.seed_ids(None)


def test_span_exports_are_jax_bytes():
    js, ps = _both("obs.spans")
    jt, pt = _both("obs.tracectx")
    got, want = _span_calls(ps, pt), _span_calls(js, jt)
    assert json.dumps(got[0]) == json.dumps(want[0])
    assert got[1:] == want[1:]
    js.validate_chrome_trace(got[0])
    assert ps.PHASE_SCOPES == js.PHASE_SCOPES


def _trace_calls(tracectx):
    tracectx.seed_ids(1234)
    try:
        root = tracectx.mint()
        child = root.child()
        linked = tracectx.from_header(child.to_header(),
                                      link=tracectx.LINK_RECOVERS)
        return [root.to_header(), child.to_header(), linked.to_header(),
                linked.link, tracectx.span_fields(linked)]
    finally:
        tracectx.seed_ids(None)


def test_trace_context_headers_are_jax_bytes():
    jt, pt = _both("obs.tracectx")
    assert _trace_calls(pt) == _trace_calls(jt)
    for bad in ("00-zz-11-01", "junk"):
        with pytest.raises(ValueError):
            pt.parse_header(bad)
        with pytest.raises(ValueError):
            jt.parse_header(bad)


def _slo_calls(slo):
    pol = slo.SLOPolicy.parse("interactive:1000:100,batch:60000:5000")
    tr = slo.SLOTracker(pol)
    tr.observe(None, 0.5, 0.05, 10)
    tr.observe("batch", 70.0, 0.01, 4)
    tr.observe("interactive", None, None, 0, failed=True)
    return (pol.names, pol.default_class, pol.rank("batch"), tr.snapshot(),
            slo.SLOPolicy.serving_default().names)


def test_slo_policy_and_tracker_are_jax_objects():
    js, ps = _both("obs.slo")
    assert _slo_calls(ps) == _slo_calls(js)
    with pytest.raises(ValueError):
        ps.SLOPolicy.parse("nope")


def _watch_calls(watch):
    tower = watch.Watchtower()
    tower.thresholds["recovery_storm_min"] = 1
    fired = []
    for n in (0, 1, 2, 2):
        s = watch.blank_sample()
        s["recoveries"] = n
        fired += [(i.kind, i.tick, i.note) for i in
                  tower.observe("self", s)]
    snap = tower.snapshot()
    return fired, snap, sorted(tower.states().items())


def test_watchtower_fires_as_jax():
    jw, pw = _both("obs.watch")
    got = _watch_calls(pw)
    assert got == _watch_calls(jw) and got[0]


def test_fleet_rows_are_jax_rows():
    jf, pf = _both("obs.fleet")
    payload = {"schema": 3, "state": "serving", "active": 1, "queued": 2,
               "queue_depth": 2, "slots": 4, "occupancy": 0.25,
               "paged_kv": {"pages": 24, "pages_free": 17,
                            "prefix_hits": 5, "prefix_misses": 2,
                            "prefill_tokens_saved": 12}}
    rows = [f.signals_from_health("r", payload) for f in (jf, pf)]
    keep = ("schema", "present", "healthy", "kv_pages", "kv_pages_free",
            "prefix_hits", "queue_depth", "occupancy")
    assert ({k: getattr(rows[1], k) for k in keep}
            == {k: getattr(rows[0], k) for k in keep})


def test_log_json_lines_carry_the_jax_keys(monkeypatch):
    jl, pl = _both("obs.log")
    monkeypatch.setenv("DLLAMA_LOG_JSON", "1")
    lines = []
    for log in (jl, pl):
        buf = io.StringIO()
        log.log_event("server.drain", "🌐 text", file=buf, outstanding=2)
        lines.append(json.loads(buf.getvalue()))
    assert set(lines[1]) == set(lines[0])
    for k in ("event", "outstanding", "tp_scheme", "q40_body"):
        assert lines[1][k] == lines[0][k]
    assert set(lines[1]["env_fingerprint"]) >= {"clock",
                                                "clock_resolution_s"}
    monkeypatch.setenv("DLLAMA_LOG_JSON", "0")
    buf = io.StringIO()
    pl.log_event("server.drain", "🌐 text", file=buf, outstanding=2)
    pl.log_event("json.only", None, file=buf)
    assert buf.getvalue() == "🌐 text\n"


def test_run_stamp_has_the_jax_keys():
    jf, pf = _both("utils.fingerprint")
    got, want = pf.run_stamp(), jf.run_stamp()
    assert set(got) == set(want)
    assert got["tp_scheme"] == want["tp_scheme"]
    assert got["env_fingerprint"]["clock"] == want["env_fingerprint"][
        "clock"]
