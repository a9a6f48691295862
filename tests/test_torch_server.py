"""The port's HTTP server (runtime/server.py) against the JAX package's
InferenceServer, on the CPU (the kernels' plain versions), the same model
and payloads on both:

* responses, concurrent and streamed (NDJSON), greedy and seeded, equal
  JAX's, and the greedy ones the solo ``ContinuousEngine.run``'s, over
  paged pages with admission prefill and with speculative decoding;
* after the same sequential traffic, /health has JAX's keys in every
  block and its deterministic values, /metrics its families and its
  deterministic counters, /debug/sched its keys; /debug/timeline passes
  the JAX validate_chrome_trace;
* the error paths give JAX's codes and messages (400 malformed, the
  oversized prompt's 400 with its own rejection reason, 404, 503 while
  draining, 500 when a dispatch raises);
* drain journals what is still in flight (live in the journal, the
  waiter answered 500) and stop() leaves no thread behind;
* a watch_tick incident dumps a flight-recorder bundle that the JAX
  validate_bundle accepts.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_continuous import SPEC, _host, _port_spec

from distributed_llama_tpu.models.synth import synth_params


class _IdTokenizer:
    """Bytes + 3 (lowercase prompts stay under the 128-token vocab)."""

    def encode(self, text, bos=True, eos=False):
        return [1] + [3 + b for b in text.encode()]

    def decode_piece(self, prev, tok):
        return b"<%d>" % tok


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the small CPU forwards (xdist workers with
    full pools ran ~10x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    params = synth_params(SPEC, q40=True, seed=4, scale=0.3)
    return params, _host(params)


def _server(package, model, **kw):
    """An InferenceServer of either package over the same weights."""
    params, host = model
    opts = dict(slots=2, steps=12, temperature=0.0, topp=0.9, seed=5,
                quiet=True)
    opts.update(kw)
    if package == "jax":
        from distributed_llama_tpu.runtime.server import InferenceServer

        return InferenceServer(SPEC, params, _IdTokenizer(), "127.0.0.1", 0,
                               **opts)
    from distributed_llama_tpu_torch.runtime.server import InferenceServer

    return InferenceServer(_port_spec(SPEC), host, _IdTokenizer(),
                           "127.0.0.1", 0, device="cpu", **opts)


def _post(port, payload):
    """(status, body): the JSON reply, or the NDJSON lines of a stream."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            if payload.get("stream"):
                return r.status, [json.loads(ln) for ln in r]
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return r.read()


def _tokens(reply):
    status, body = reply
    assert status == 200, body
    if isinstance(body, list):  # a stream: token lines, then done
        assert body[-1]["done"] and "error" not in body[-1]
        return [ln["token"] for ln in body[:-1]]
    return body["tokens"]


SEQUENTIAL = [{"prompt": "hello", "steps": 20},
              {"prompt": "hello there", "steps": 24, "stream": True},
              {"prompt": "abc", "steps": 16, "temperature": 0.8,
               "seed": 11}]
CONCURRENT = [{"prompt": "abcdefgh", "steps": 20},
              {"prompt": "xyz", "steps": 18, "stream": True},
              {"prompt": "hello world", "steps": 24, "temperature": 0.8,
               "topp": 0.9, "seed": 3, "stream": True},
              {"prompt": "qq", "steps": 12, "temperature": 0.8, "seed": 9}]
CONFIGS = {"paged-chunk4": dict(page_size=4, prefill_chunk=4),
           "paged-spec4": dict(page_size=4, spec_k=4)}


def _traffic(package, model, opts, tmp_path):
    """The scripted traffic against one server: the sequential requests,
    then the surfaces read, then the concurrent ones."""
    from_jax = package == "jax"
    if from_jax:
        from distributed_llama_tpu.runtime.journal import RequestJournal
    else:
        from distributed_llama_tpu_torch.runtime.journal import \
            RequestJournal
    journal = RequestJournal(str(tmp_path / f"{package}.wal"), fsync="off")
    srv = _server(package, model, journal=journal, **opts)
    srv.start()
    try:
        seq = [_tokens(_post(srv.port, p)) for p in SEQUENTIAL]
        out = dict(seq=seq, health=json.loads(_get(srv.port, "/health")),
                   metrics=_get(srv.port, "/metrics").decode(),
                   timeline=json.loads(_get(srv.port, "/debug/timeline")),
                   sched=json.loads(_get(srv.port, "/debug/sched")))
        replies = [None] * len(CONCURRENT)

        def one(i):
            replies[i] = _post(srv.port, CONCURRENT[i])

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(CONCURRENT))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out["concurrent"] = [_tokens(r) for r in replies]
    finally:
        srv.stop()
    return out


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request, model, tmp_path_factory):
    opts = CONFIGS[request.param]
    d = tmp_path_factory.mktemp(request.param)
    return request.param, {pkg: _traffic(pkg, model, opts, d)
                           for pkg in ("jax", "port")}


def test_responses_equal_jax_and_the_solo_engine(runs, model):
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine

    name, got = runs
    assert got["port"]["seq"] == got["jax"]["seq"]
    assert got["port"]["concurrent"] == got["jax"]["concurrent"]
    tok = _IdTokenizer()
    greedy = [p for p in SEQUENTIAL + CONCURRENT if "temperature" not in p]
    solo = ContinuousEngine(_port_spec(SPEC), model[1], 1, 0.0, 0.9, 5,
                            device="cpu", **CONFIGS[name])
    served = [o for p, o in zip(SEQUENTIAL + CONCURRENT,
                                got["port"]["seq"] + got["port"]["concurrent"])
              if "temperature" not in p]
    for p, o in zip(greedy, served):
        want, _ = solo.run([tok.encode(p["prompt"])], p["steps"])
        assert o == want[0]


def _keys(obj, prefix=""):
    """Every key path of a JSON object (lists by their first element)."""
    out = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.add(prefix + k)
            out |= _keys(v, prefix + k + ".")
    return out


# /health values that are times or paths, not the engine's state
_TIMED = ("uptime_s", "ttft_s", "token_latency_s", "queue_wait_s",
          "journal.path", "sched.cost_totals", "sched.cost_by_class")


def _flat(obj, prefix=""):
    out = {}
    for k, v in obj.items():
        key = prefix + k
        if any(key == t or key.startswith(t + ".") for t in _TIMED):
            continue
        if isinstance(v, dict):
            out.update(_flat(v, key + "."))
        else:
            out[key] = v
    return out


def test_health_has_jax_keys_and_values(runs):
    _, got = runs
    jh, ph = got["jax"]["health"], got["port"]["health"]
    assert _keys(ph) == _keys(jh)
    assert _flat(ph) == _flat(jh)
    assert ph["schema"] == 3 and ph["state"] == "serving"
    assert set(ph["sched"]["cost_totals"]) == set(jh["sched"]["cost_totals"])


def _series(text):
    """{series: value} of an exposition, and its family names."""
    values, families = {}, set()
    for ln in text.splitlines():
        if ln.startswith("# TYPE "):
            families.add(ln.split()[2])
        elif ln and not ln.startswith("#"):
            name, value = ln.rsplit(" ", 1)
            values[name] = float(value)
    return values, families


# counters and gauges that count events, not seconds or builds (XLA
# compiles one program a shape; the port captures graphs on the card)
_COUNTED = ("dllama_requests_total", "dllama_generated_tokens_total",
            "dllama_engine_steps_total", "dllama_prefix_hits_total",
            "dllama_prefill_tokens_saved_total", "dllama_kv_pages_free",
            "dllama_dispatch_tokens_total", "dllama_journal_records_total",
            "dllama_spec_proposed_total", "dllama_spec_accepted_total",
            "dllama_slot_pauses_total", "dllama_admission_rejected_total",
            "dllama_request_ttft_seconds_count",
            "dllama_kv_page_pool_bytes", "dllama_queue_depth",
            "dllama_slo_requests_total", "dllama_health_state")


def test_metrics_have_jax_families_and_counts(runs):
    _, got = runs
    jv, jf = _series(got["jax"]["metrics"])
    pv, pf = _series(got["port"]["metrics"])
    assert pf == jf
    counted = {k: v for k, v in jv.items() if k.startswith(_COUNTED)}
    assert counted and {k: pv.get(k) for k in counted} == counted


def test_debug_surfaces_match_jax(runs):
    from distributed_llama_tpu.obs.spans import validate_chrome_trace

    _, got = runs
    validate_chrome_trace(got["port"]["timeline"])
    names = {e["name"] for e in got["port"]["timeline"]["traceEvents"]}
    assert names == {e["name"]
                     for e in got["jax"]["timeline"]["traceEvents"]}
    assert _keys(got["port"]["sched"]) == _keys(got["jax"]["sched"])
    assert (got["port"]["sched"]["totals"]
            == got["jax"]["sched"]["totals"])


BAD = [{"steps": 0}, {"steps": SPEC.seq_len + 1}, {"prompt": 7},
       {"steps": [1]}, {"temperature": {}}, {"prompt": "x" * 40},
       {"class": "gold"}]


def test_error_paths_give_jax_codes_and_messages(model):
    """400 for malformed payloads, the oversized prompt and steps (JAX's
    OversizedRequest answers 400 with its own rejection reason), 404 for
    an unknown path, 503 while draining, 500 when the dispatch raises."""
    got = {}
    for pkg in ("jax", "port"):
        srv = _server(pkg, model, page_size=4)
        if pkg == "jax":
            def boom(*a, **k):
                raise RuntimeError("injected device fault")

            srv.engine._step = boom
        else:
            def boom(*a, **k):
                raise RuntimeError("injected device fault")

            srv.engine._forward_into_logits = boom
        srv.start()
        try:
            res = [_post(srv.port, p) for p in BAD]
            res.append(_post(srv.port, {"prompt": "ab", "steps": 4}))
            try:
                _get(srv.port, "/nope")
            except urllib.error.HTTPError as e:
                res.append((e.code, json.loads(e.read())))
            metrics = _get(srv.port, "/metrics").decode()
            srv.health.to("draining")
            res.append(_post(srv.port, {"prompt": "ab"}))
        finally:
            srv.stop()
        rejected = {k: v for k, v in _series(metrics)[0].items()
                    if k.startswith("dllama_admission_rejected_total")}
        got[pkg] = res, rejected
    assert got["port"] == got["jax"]
    codes = [c for c, _ in got["port"][0]]
    assert codes == [400] * len(BAD) + [500, 404, 503]
    assert "injected device fault" in got["port"][0][len(BAD)][1]["error"]
    assert got["port"][1][
        'dllama_admission_rejected_total{reason="oversized"}'] == 2


def test_drain_journals_the_remainder_and_stop_leaves_no_threads(model,
                                                                 tmp_path):
    from distributed_llama_tpu.runtime.journal import \
        load_journal as jax_load
    from distributed_llama_tpu_torch.runtime.journal import (RequestJournal,
                                                             load_journal)

    before = set(threading.enumerate())
    path = str(tmp_path / "j.wal")
    srv = _server("port", model, page_size=4, kv_pages=24,
                  journal=RequestJournal(path))
    step = srv.engine._forward_into_logits

    def slow():  # a dispatch the drain budget cannot wait out
        time.sleep(0.2)
        step()

    srv.engine._forward_into_logits = slow
    srv.start()
    got = {}
    client = threading.Thread(
        target=lambda: got.update(r=_post(srv.port, {"prompt": "hello",
                                                     "steps": 20,
                                                     "stream": True})))
    client.start()
    deadline = time.time() + 30
    while time.time() < deadline and not any(
            not s.free for s in srv.engine._pool):
        time.sleep(0.01)
    assert srv.drain(budget_s=0.05) == 1
    client.join(30)
    status, lines = got["r"]
    assert status == 200 and "journaled" in lines[-1]["error"]
    assert srv.health.state == "stopped" and srv.engine.audit_pages() == []
    for load in (load_journal, jax_load):  # either package reads it live
        live = [e for e in load(path) if e.status is None]
        assert len(live) == 1 and live[0].tokens[:2] == [1, 3 + ord("h")]
    time.sleep(0.1)
    assert set(threading.enumerate()) <= before
    assert srv.drain() == 0  # a stopped server drains nothing


def test_incident_bundle_passes_the_jax_validator(model, tmp_path):
    from distributed_llama_tpu.obs.flightrec import (load_bundle,
                                                     validate_bundle)
    from distributed_llama_tpu_torch.obs.watch import blank_sample

    srv = _server("port", model, page_size=4, flightrec_dir=str(tmp_path))
    srv.start()
    try:
        assert srv.watch_tick() == []  # a healthy self-scrape fires nothing
        srv._watch.thresholds["recovery_storm_min"] = 1
        fired = []
        for n in (1, 2):
            s = blank_sample()
            s["recoveries"] = n
            fired += srv._watch.observe("self", s)
        assert [i.kind for i in fired] == ["recovery_storm"]
        doc = json.loads(_get(srv.port, "/debug/incidents?kind="
                                        "recovery_storm"))
        assert doc["incident_log"][0]["evidence"]
        assert json.loads(_get(srv.port, "/health"))["watch"][
            "incidents_total"] == 1
    finally:
        srv.stop()
    (path,) = [p for p in tmp_path.iterdir()
               if p.name.startswith("flightrec-incident-")]
    bundle = load_bundle(str(path))
    validate_bundle(bundle)
    assert bundle["reason"] == "incident"
    assert bundle["incident_kind"] == "recovery_storm"
    assert np.isfinite(bundle["ts"])
