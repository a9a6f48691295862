"""The port's prefill/decode disaggregation (runtime/disagg.py,
runtime/page_channel.py, the engine's remote adoption, slo_priority and
prefill_hold) against the JAX package's, on the CPU: the twins of
tests/test_disagg.py (its two-pool virtual-clock sweep and the memory
model aside), and cases across the packages.

* a handed-off request's stream equals the single-pool run's, the port's
  and the JAX engine's, greedy and seeded, f32 and Q8 pages, in memory
  and over the TCP page channel; both pools' audits close;
* a mid-transfer cancel frees the pages on both pools, a page that never
  arrived stops adoption at the gap, the shipped prefix is published on
  the decode pool, the inbox adopts on the scheduler thread, and the
  prejournal is the durability point;
* slo_priority pops the interactive class first, prefill_hold parks at
  page-aligned boundaries (f32 only) and resumes to the same stream;
* ``dcn_page_bytes`` and ``dcn_handoff_budget`` equal the JAX functions
  and the bytes ``export_prefix_pages`` ships;
* the channel's retention cap, unknown handoffs and CRC re-fetch; a JAX
  prefill engine's pages served by a JAX PageChannelServer adopt into a
  port decode engine with the JAX single-pool stream, and a port server
  serves a JAX client.
"""

import socketserver
import struct
import threading

import numpy as np
import pytest
import torch

from distributed_llama_tpu.models.spec import TransformerSpec
from distributed_llama_tpu.models.synth import synth_params
from distributed_llama_tpu_torch.obs.metrics import Registry
from distributed_llama_tpu_torch.runtime import pagewire
from distributed_llama_tpu_torch.runtime.continuous import (ContinuousEngine,
                                                            Request)
from distributed_llama_tpu_torch.runtime.disagg import (
    DisaggPair, decode_request, entry_for_stub, export_prefix_pages,
    make_priority_hold, prefill_stub, stub_needs_handoff)
from distributed_llama_tpu_torch.runtime.journal import (RequestJournal,
                                                         entry_from_wire,
                                                         entry_to_wire)

SPEC = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                       n_kv_heads=2, vocab_size=128, seq_len=32)
_FIELDS = ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads",
           "vocab_size", "seq_len")
# prompts spanning >= 2 full pages (page_size 4) so handoffs ship real
# pages; the first two share their full-page prefix, the third is short
REQS = [[1, 9, 17, 25, 31, 7, 3, 44, 11],
        [1, 9, 17, 25, 31, 7, 3, 44, 5],
        [1, 5, 6]]
STEPS = 20


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    from distributed_llama_tpu_torch.models.spec import TransformerSpec as P

    params = synth_params(SPEC, q40=False, seed=4, scale=0.3)
    return (P(**{f: getattr(SPEC, f) for f in _FIELDS}),
            {k: np.asarray(v) for k, v in params.items()}, params)


def make_engine(model, journal=None, remote=False, temp=0.8,
                kv_quant="f32", **kw):
    base = dict(slots=2, temperature=temp, topp=0.9, seed=11,
                prefill_chunk=4, page_size=4, kv_pages=24)
    base.update(kw)
    return ContinuousEngine(model[0], model[1], journal=journal,
                            remote_pages=remote, kv_quant=kv_quant,
                            device="cpu", **base)


def jax_engine(model, temp=0.8, kv_quant="f32", **kw):
    from distributed_llama_tpu.runtime.continuous import \
        ContinuousEngine as JaxEngine

    base = dict(slots=2, temperature=temp, topp=0.9, seed=11,
                prefill_chunk=4, page_size=4, kv_pages=24)
    base.update(kw)
    return JaxEngine(SPEC, model[2], kv_quant=kv_quant,
                     use_native_sampler=False, **base)


def make_pair(model, tmp_path, temp=0.8, kv_quant="f32", channel=None,
              registry=None):
    journal = RequestJournal(str(tmp_path / "prefill.journal"))
    pair = DisaggPair(
        make_engine(model, journal=journal, temp=temp, kv_quant=kv_quant),
        make_engine(model, remote=True, temp=temp, kv_quant=kv_quant),
        channel_host=channel, registry=registry)
    return pair, journal


def _close(pair, journal):
    pair.close()
    journal.close()


# ------------------------------------------------------ bitwise handoff


@pytest.mark.parametrize("temp", [0.0, 0.8])
@pytest.mark.parametrize("kv_quant", ["f32", "q8"])
def test_handoff_stream_bitwise_vs_single_pool(model, tmp_path, temp,
                                               kv_quant):
    ref_outs, _ = make_engine(model, temp=temp, kv_quant=kv_quant).run(
        REQS, steps=STEPS)
    jax_outs, _ = jax_engine(model, temp=temp, kv_quant=kv_quant).run(
        REQS, steps=STEPS)
    pair, journal = make_pair(model, tmp_path, temp=temp,
                              kv_quant=kv_quant)
    outs, summary = pair.run(REQS, steps=STEPS)
    assert outs == ref_outs == jax_outs
    assert summary["shipped"] >= 1 and summary["pages_adopted"] >= 2
    assert pair.prefill.audit_pages() == []
    assert pair.decode.audit_pages() == []
    _close(pair, journal)


def test_handoff_over_tcp_channel_bitwise(model, tmp_path):
    ref_outs, _ = make_engine(model).run(REQS, steps=STEPS)
    reg = Registry()
    pair, journal = make_pair(model, tmp_path, channel="127.0.0.1",
                              registry=reg)
    outs, summary = pair.run(REQS, steps=STEPS)
    assert outs == ref_outs
    assert summary["pages_adopted"] >= 2
    text = reg.expose()
    shipped = [ln for ln in text.splitlines()
               if ln.startswith("dllama_dcn_pages_shipped_total")]
    assert shipped and float(shipped[0].split()[-1]) >= 2
    assert 'dllama_handoff_requests_total{verdict="shipped"}' in text
    _close(pair, journal)


def test_handoff_record_wire_roundtrip(model, tmp_path):
    pair, journal = make_pair(model, tmp_path)
    stub, may = prefill_stub(REQS[0], STEPS)
    assert may
    pair.prefill.submit(stub)
    pair._drain(pair.prefill)
    assert stub_needs_handoff(stub)
    entry = entry_for_stub(pair.prefill, stub)
    back = entry_from_wire(entry_to_wire(entry))
    assert back.replay_tokens == entry.replay_tokens
    assert (back.cursor, back.seed) == (entry.cursor, entry.seed)
    assert (back.temperature, back.topp) == (entry.temperature, entry.topp)
    with pytest.raises(ValueError):
        entry_from_wire({"id": 1, "tokens": []})
    with pytest.raises(ValueError):
        entry_from_wire({"tokens": [1, 2]})
    _close(pair, journal)


def test_journal_less_sampled_handoff_refuses(model):
    eng = make_engine(model, temp=0.8)
    stub, _ = prefill_stub(REQS[0], STEPS)
    eng.submit(stub)
    while eng.step_many(1, quiet=True):
        pass
    with pytest.raises(ValueError, match="journal"):
        entry_for_stub(eng, stub)
    eng2 = make_engine(model, temp=0.0)
    stub2, _ = prefill_stub(REQS[0], STEPS)
    eng2.submit(stub2)
    while eng2.step_many(1, quiet=True):
        pass
    entry = entry_for_stub(eng2, stub2)
    assert entry.cursor == 0
    assert entry.replay_tokens == list(stub2.tokens) + stub2.out[8:]


# ---------------------------------------------------------- edge cases


def test_mid_transfer_cancel_frees_pages_on_both_pools(model, tmp_path):
    pair, journal = make_pair(model, tmp_path, channel="127.0.0.1")
    free0 = pair.decode.allocator.n_free
    stub, _ = prefill_stub(REQS[0], STEPS)
    pair.prefill.submit(stub)
    pair._drain(pair.prefill)
    h = pair.handoff(stub, STEPS)
    assert h is not None and h.n_pages == 2 and len(h.adopted) == 2
    assert all(n.pending for n in h.adopted)
    pair.cancel(h)  # before the decode pool ever steps
    pair._drain(pair.decode)
    assert h.req.done.is_set() and h.req.cancelled
    assert pair.decode.allocator.n_free == free0
    assert pair.prefill.audit_pages() == []
    assert pair.decode.audit_pages() == []
    assert not pair.decode.page_io.inflight
    _close(pair, journal)


def test_radix_publish_lands_on_decode_pool(model, tmp_path):
    pair, journal = make_pair(model, tmp_path)
    a = pair.decode.allocator
    outs, _ = pair.run([REQS[0]], steps=STEPS)
    assert a.remote_adopted == 2
    outs2, _ = pair.run([REQS[1]], steps=STEPS)
    assert a.remote_adopted == 2  # the windows were already present
    assert a.prefix_hits >= 1 and a.tokens_saved >= 8
    ref_outs, _ = make_engine(model).run([REQS[0], REQS[1]], steps=STEPS)
    assert outs[0] == ref_outs[0] and outs2[0] == ref_outs[1]
    _close(pair, journal)


def test_dropped_page_in_flight_stops_adoption_at_gap(model, tmp_path):
    ref_outs, _ = make_engine(model).run([REQS[0]], steps=STEPS)
    pair, journal = make_pair(model, tmp_path)
    stub, _ = prefill_stub(REQS[0], STEPS)
    pair.prefill.submit(stub)
    pair._drain(pair.prefill)
    entry = entry_for_stub(pair.prefill, stub)
    payloads = export_prefix_pages(pair.prefill, stub.tokens)
    adopted = pair.decode.adopt_remote(stub.tokens[:8],
                                       [payloads[0], None])
    assert len(adopted) == 1
    req = decode_request(entry, STEPS)
    pair.decode.submit(req)
    pair._drain(pair.decode)
    assert req.out == ref_outs[0]
    assert pair.decode.audit_pages() == []
    _close(pair, journal)


def test_remote_ingest_inbox_adopts_on_scheduler_thread(model, tmp_path):
    ref_outs, _ = make_engine(model).run([REQS[0]], steps=STEPS)
    pair, journal = make_pair(model, tmp_path)
    stub, _ = prefill_stub(REQS[0], STEPS)
    pair.prefill.submit(stub)
    pair._drain(pair.prefill)
    req = decode_request(entry_for_stub(pair.prefill, stub), STEPS)
    planes = export_prefix_pages(pair.prefill, stub.tokens)
    pair.decode.ingest_remote(stub.tokens[:8], planes, req)
    assert pair.decode._n_outstanding() == 1  # the inbox counts as work
    pair._drain(pair.decode)
    assert req.out == ref_outs[0]
    assert pair.decode.allocator.remote_adopted == 2
    _close(pair, journal)


def test_ingest_remote_requires_remote_engine(model):
    with pytest.raises(ValueError, match="remote_pages"):
        make_engine(model).ingest_remote([1, 2, 3, 4], [],
                                         Request(tokens=[1], steps=2))


def test_export_prefix_sync_fulfils_from_scheduler(model):
    eng = make_engine(model, temp=0.0)
    eng.run([REQS[0]], steps=STEPS)  # publishes the prompt pages
    box = {}
    t = threading.Thread(target=lambda: box.setdefault(
        "planes", eng.export_prefix_sync(REQS[0], timeout=10)))
    t.start()
    for _ in range(200):
        if "planes" in box:
            break
        eng.step_many(1, quiet=True)
    t.join(timeout=10)
    assert len(box["planes"]) == 2


def test_prejournal_is_the_durability_point(model, tmp_path):
    jp = str(tmp_path / "decode.journal")
    eng = make_engine(model, temp=0.0, remote=True,
                      journal=RequestJournal(jp))
    dreq = Request(tokens=list(REQS[0]), steps=STEPS, temperature=0.0,
                   topp=0.9, seed=501)
    eng.prejournal(dreq)
    assert dreq.prejournaled
    eng._journal._fh.close()  # "crash" before submit
    eng2 = make_engine(model, temp=0.0, remote=True,
                       journal=RequestJournal(jp))
    assert eng2.recover() == 1
    while eng2.step_many(1, quiet=True):
        pass
    dreq2 = Request(tokens=list(REQS[1]), steps=STEPS, temperature=0.0,
                    topp=0.9, seed=502)
    eng2.prejournal(dreq2)
    before = eng2._journal.records_total
    eng2.submit(dreq2)
    assert eng2._journal.records_total == before
    while eng2.step_many(1, quiet=True):
        pass
    dreq3 = Request(tokens=list(REQS[0]), steps=STEPS, temperature=0.0,
                    topp=0.9, seed=503)
    eng2.prejournal(dreq3)
    eng2.abandon_prejournaled(dreq3)
    assert eng2._journal.incomplete() == []


# -------------------------------------------------- scheduler machinery


def test_slo_priority_pops_interactive_first(model):
    from distributed_llama_tpu_torch.obs.slo import SLOPolicy

    eng = make_engine(model, slo=SLOPolicy.serving_default(),
                      slo_priority=True, slots=1)
    batch = [Request(tokens=[1, 5 + i, 7], steps=6, slo_class="batch")
             for i in range(3)]
    inter = Request(tokens=[1, 40, 41], steps=6, slo_class="interactive")
    for r in batch + [inter]:
        eng.submit(r)
    eng.step_many(1, quiet=True)  # admits exactly one (slots=1)
    assert [s.req for s in eng._pool if not s.free] == [inter]
    while eng.step_many(1, quiet=True):
        pass
    assert all(r.done.is_set() for r in batch + [inter])


def test_slo_priority_requires_policy(model):
    with pytest.raises(ValueError, match="slo_priority"):
        make_engine(model, slo_priority=True)


LONG = [1] + [(7 * j) % 90 + 5 for j in range(24)] + [3]


def test_prefill_hold_parks_at_page_boundary_and_resumes(model):
    ref_outs, _ = make_engine(model, temp=0.0).run([LONG], steps=30)
    (jax_out,), _ = jax_engine(model, temp=0.0).run([LONG], steps=30)
    eng = make_engine(model, temp=0.0)
    eng.prefill_hold = lambda slot: True  # park at EVERY boundary
    batch = eng.submit(Request(tokens=list(LONG), steps=30))
    eng.step_many(1, quiet=True)
    parked = [s for s in eng._pool if not s.free and s.prefill_pending]
    assert parked and parked[0].pos % eng.page_size == 0
    pos0 = parked[0].pos
    eng.step_many(1, quiet=True)  # resume makes chunk progress
    assert parked[0].free or parked[0].pos > pos0
    while eng.step_many(1, quiet=True):
        pass
    assert batch.out == ref_outs[0] == jax_out
    assert eng.audit_pages() == [] and eng.stats.prefill_chunks > 0
    kinds = {c for r in eng.sched_census.tail(64)
             for c in r.get("parked", {})}
    assert "prefill_hold" in kinds


def test_prefill_hold_ignored_on_q8_pools(model):
    ref_outs, _ = make_engine(model, temp=0.0, kv_quant="q8").run(
        [LONG], steps=30)
    eng = make_engine(model, temp=0.0, kv_quant="q8")
    eng.prefill_hold = lambda slot: True
    batch = eng.submit(Request(tokens=list(LONG), steps=30))
    eng.step_many(1, quiet=True)
    assert not any(s.prefill_pending for s in eng._pool)
    while eng.step_many(1, quiet=True):
        pass
    assert batch.out == ref_outs[0]


def test_make_priority_hold_fires_only_for_lower_ranked_slot(model):
    import types

    from distributed_llama_tpu_torch.obs.slo import SLOPolicy

    policy = SLOPolicy.serving_default()
    eng = make_engine(model, slo=policy)
    hold = make_priority_hold(eng, policy)
    with eng._lock:
        eng._queue.append(Request(tokens=[1, 2], steps=4,
                                  slo_class="interactive"))
    batch_slot = types.SimpleNamespace(
        req=Request(tokens=[1, 3], steps=4, slo_class="batch"))
    inter_slot = types.SimpleNamespace(
        req=Request(tokens=[1, 4], steps=4, slo_class="interactive"))
    assert hold(batch_slot) and not hold(inter_slot)
    with eng._lock:
        eng._queue.clear()
    assert not hold(batch_slot)


def test_remote_pages_requires_paged_engine(model):
    with pytest.raises(ValueError, match="remote_pages"):
        ContinuousEngine(model[0], model[1], slots=2, temperature=0.0,
                         topp=0.9, seed=1, remote_pages=True, device="cpu")


# ---------------------------------------------------------------- bytes


@pytest.mark.parametrize("kv_quant", ["f32", "q8"])
def test_dcn_budget_prices_pages_per_kv_quant(model, kv_quant):
    """The port's dcn_page_bytes and dcn_handoff_budget equal the JAX
    functions, and the pages a real handoff exports weigh exactly the
    budget (the memory-model half of the JAX case is not ported)."""
    from distributed_llama_tpu.parallel import comm_stats as ref_cs
    from distributed_llama_tpu_torch.parallel.comm_stats import (
        dcn_handoff_budget, dcn_page_bytes)

    for n_pos, ps in ((10, 4), (16, 4), (8, 2)):
        assert dcn_handoff_budget(model[0], 1, n_pos, ps, kv_quant) == \
            ref_cs.dcn_handoff_budget(SPEC, 1, n_pos, ps, kv_quant)
        assert dcn_page_bytes(model[0], 1, ps, kv_quant) == \
            ref_cs.dcn_page_bytes(SPEC, 1, ps, kv_quant)
    f32 = dcn_handoff_budget(model[0], 1, 16, 4, "f32")["bytes"]
    q8 = dcn_handoff_budget(model[0], 1, 16, 4, "q8")["bytes"]
    assert f32 / q8 == pytest.approx(128 / 34, rel=1e-6)
    eng = make_engine(model, temp=0.0, kv_quant=kv_quant)
    eng.run([REQS[0]], steps=STEPS)
    payloads = export_prefix_pages(eng, REQS[0])
    assert sum(pagewire.record_payload_bytes(p) for p in payloads) == \
        dcn_handoff_budget(model[0], 1, 8, 4, kv_quant)["bytes"]


def test_7b_page_bytes():
    """7B at page size 16: 16,777,216 B an f32 page, 4,456,448 B Q8."""
    from distributed_llama_tpu_torch.models.spec import TransformerSpec as P
    from distributed_llama_tpu_torch.parallel.comm_stats import \
        dcn_page_bytes

    spec = P(dim=4096, hidden_dim=11008, n_layers=32, n_heads=32,
             n_kv_heads=32, vocab_size=32000, seq_len=2048)
    assert dcn_page_bytes(spec, 1, 16, "f32") == 16_777_216
    assert dcn_page_bytes(spec, 1, 16, "q8") == 4_456_448


# ------------------------------------------------------------ channel


def _records(n=3, seed=9):
    rng = np.random.default_rng(seed)
    planes = [(rng.standard_normal((2, 4, 2, 16)).astype(np.float32),
               rng.standard_normal((2, 4, 2, 16)).astype(np.float32))
              for _ in range(n)]
    return planes, [pagewire.encode_record(p) for p in planes]


def test_page_channel_round_trip_and_ack():
    from distributed_llama_tpu_torch.runtime.page_channel import (
        PageChannelClient, PageChannelServer)

    planes, records = _records()
    server = PageChannelServer()
    try:
        client = PageChannelClient(f"127.0.0.1:{server.port}")
        assert client.fetch("nope") == []
        server.publish("h1", records, trace="00-" + "a" * 32 + "-"
                       + "b" * 16 + "-01")
        assert server.queue_depth == 1
        assert client.trace("h1").startswith("00-aaaa")
        got = client.fetch("h1", len(records))
        for orig, back in zip(planes, got):
            assert all(a.tobytes() == b.tobytes()
                       for a, b in zip(orig, back))
        assert server.queue_depth == 0  # acked -> retired
    finally:
        server.close()


def test_page_channel_crc_refetch_and_give_up():
    """A frame that fails its CRC is fetched once more; damaged twice it
    comes back None (the adoption stops at the gap)."""
    from distributed_llama_tpu_torch.runtime.page_channel import \
        PageChannelClient

    _, records = _records(2)
    bad = bytearray(records[1])
    bad[-1] ^= 0xFF
    served = {"n": 0}

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            f = self.request.makefile("rb")
            while True:
                parts = f.readline().split()
                if not parts or parts[0] == b"DONE":
                    return
                if parts[0] == b"SPEC":
                    self.request.sendall(b"DLPCH1" + struct.pack("<q", 1))
                elif parts[0] == b"PAGE":
                    idx = int(parts[2])
                    served["n"] += 1
                    rec = records[0] if idx == 0 else bytes(bad)
                    self.request.sendall(struct.pack("<q", len(rec)) + rec)
                elif parts[0] == b"ACK":
                    self.request.sendall(struct.pack("<q", 0))

    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        client = PageChannelClient(f"127.0.0.1:{srv.server_address[1]}")
        got = client.fetch("h", 2)
        assert got[0] is not None and got[1] is None
        assert client.crc_refetches == 1 and served["n"] == 3
    finally:
        srv.shutdown()
        srv.server_close()


def test_page_channel_retention_cap_bounds_the_store():
    from distributed_llama_tpu_torch.runtime.page_channel import (
        PageChannelClient, PageChannelServer)

    rec = pagewire.encode_record(
        (np.arange(16, dtype=np.float32).reshape(4, 4),))
    server = PageChannelServer(retain_max=3)
    try:
        for i in range(5):
            server.publish(f"h{i}", [rec])
        assert server.queue_depth == 3 and server.evicted_handoffs == 2
        client = PageChannelClient(f"127.0.0.1:{server.port}")
        assert client.fetch("h0") == []
        assert len(client.fetch("h4", 1)) == 1
        client.ack("h3")
        assert server.queue_depth == 1
    finally:
        server.close()


@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_channel_crosses_the_packages(server_side):
    from distributed_llama_tpu.runtime import page_channel as ref_pc
    from distributed_llama_tpu_torch.runtime import page_channel as pc

    planes, records = _records(2, seed=4)
    srv_mod, cli_mod = (ref_pc, pc) if server_side == "jax" else (pc, ref_pc)
    server = srv_mod.PageChannelServer()
    try:
        server.publish("hx", records)
        got = cli_mod.PageChannelClient(
            f"127.0.0.1:{server.port}").fetch("hx")
        for orig, back in zip(planes, got):
            assert all(a.tobytes() == b.tobytes()
                       for a, b in zip(orig, back))
        assert server.queue_depth == 0
    finally:
        server.close()


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_jax_prefilled_pages_adopt_into_a_port_decode_pool(model, tmp_path,
                                                           temp):
    """A JAX prefill engine's pages, published by a JAX PageChannelServer,
    adopt into a port decode engine; its continued stream is the JAX
    single-pool stream."""
    from distributed_llama_tpu.runtime import disagg as ref_disagg
    from distributed_llama_tpu.runtime import page_channel as ref_pc
    from distributed_llama_tpu.runtime.journal import \
        RequestJournal as JaxJournal
    from distributed_llama_tpu.runtime.journal import \
        entry_to_wire as jax_to_wire
    from distributed_llama_tpu_torch.runtime.page_channel import \
        PageChannelClient

    (want,), _ = jax_engine(model, temp=temp).run([REQS[0]], steps=STEPS)
    journal = JaxJournal(str(tmp_path / "jax.journal"))
    pre = jax_engine(model, temp=temp, journal=journal)
    stub, _ = ref_disagg.prefill_stub(REQS[0], STEPS)
    pre.submit(stub)
    while pre.step_many(1, quiet=True):
        pass
    entry = entry_from_wire(jax_to_wire(ref_disagg.entry_for_stub(pre,
                                                                 stub)))
    records = ref_disagg.encode_handoff_pages(
        ref_disagg.export_prefix_pages(pre, stub.tokens))
    server = ref_pc.PageChannelServer()
    try:
        server.publish("hj", records)
        planes = PageChannelClient(f"127.0.0.1:{server.port}").fetch(
            "hj", len(records))
    finally:
        server.close()
    journal.close()
    dec = make_engine(model, temp=temp, remote=True)
    req = decode_request(entry, STEPS)
    dec.ingest_remote(list(REQS[0]), planes, req)
    while dec.step_many(1, quiet=True):
        pass
    assert dec.allocator.remote_adopted == 2
    assert req.out == want
    assert dec.audit_pages() == []
