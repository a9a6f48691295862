"""The port's KV tiers (runtime/paging.py's HostPagePool, DiskPageStore,
PageUploader and the PagedAllocator's tier half; runtime/kv_io.py's page
copies; the continuous engine's promotion PAUSE) against the JAX package's,
on the CPU: the twins of tests/test_tiering.py and of the two tiering
cases of tests/test_recovery.py.

* host pool accounting, disk round trips (bitwise), CRC damage (loads as
  nothing), the live-byte budget and dead-segment reclaim, strict LRU;
* disk segments and their ``.slices`` sidecars cross between the
  packages both ways;
* f32 demote->promote round trips are bitwise through host and disk, and
  the allocator's tier books equal the JAX allocator's;
* engine streams, greedy and seeded, f32, bf16 and Q8 pages, tiered
  against untiered and against the JAX tiered engine; a CRC-damaged disk
  tier re-derives by prefill; the PAUSE holds until the upload lands
  (driven through the uploader's gate); the savings at a working set 10x
  the pool; the tier metrics, flat when untiered; the knobs' checks;
* recovery promotes a disk-resident prefix and continues bitwise, and
  the fingerprint's tier keys refuse a changed tier config.
"""

import os
import threading

import numpy as np
import pytest

from distributed_llama_tpu.models.spec import TransformerSpec
from distributed_llama_tpu.models.synth import synth_params
from distributed_llama_tpu.runtime import paging as ref_paging
from distributed_llama_tpu_torch.runtime.paging import (TIER_DISK, TIER_HOST,
                                                        DiskPageStore,
                                                        HostPagePool,
                                                        PagedAllocator)

SPEC = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                       n_kv_heads=2, vocab_size=128, seq_len=32)
PS = 4
_FIELDS = ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads",
           "vocab_size", "seq_len")


def _port_spec(spec=SPEC):
    from distributed_llama_tpu_torch.models.spec import TransformerSpec as PS_

    return PS_(**{f: getattr(spec, f) for f in _FIELDS})


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    p = synth_params(SPEC, q40=False, seed=4, scale=0.3)
    return p, {k: np.asarray(v) for k, v in p.items()}


def _engine(params, jax=False, **kw):
    base = dict(slots=2, temperature=0.0, topp=0.9, seed=3,
                prefill_chunk=PS, page_size=PS)
    base.update(kw)
    if jax:
        from distributed_llama_tpu.runtime.continuous import \
            ContinuousEngine

        return ContinuousEngine(SPEC, params[0], use_native_sampler=False,
                                **base)
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine

    return ContinuousEngine(_port_spec(), params[1], device="cpu", **base)


def _waves(n_prefix, tails=(3, 9)):
    """Two passes over n_prefix distinct 2-page shared prefixes: pass 1
    publishes, pass 2 revisits every one (by then cold prefixes spilled,
    or died on a drop-on-evict pool)."""
    return [[[1] + [(7 * i + j) % 90 + 5 for j in range(2 * PS)]
             + [t + i % 40] for i in range(n_prefix)] for t in tails]


def _two_waves(eng, w1, w2, steps=16, reset=False):
    t1, _ = eng.run(w1, steps=steps)
    if reset:
        eng.allocator.reset_counters()
    t2, _ = eng.run(w2, steps=steps)
    return t1, t2


def _payload(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, PS, 2, 16).astype(np.float32),
            rng.randn(2, PS, 2, 16).astype(np.float32))


# -- HostPagePool -----------------------------------------------------------


def test_host_pool_ids_lowest_first_and_accounting():
    pool = HostPagePool(3)
    a = pool.store(("a",))
    b = pool.store(("b",))
    assert (a, b) == (0, 1)
    assert pool.load(a) == ("a",)
    assert pool.free(a) == ("a",)
    assert pool.store(("c",)) == 0  # freed id reused, lowest-first
    pool.store(("d",))
    assert pool.store(("overflow",)) is None  # full reports, not raises
    assert pool.n_free == 0 and pool.n_live == 3
    assert pool.audit() == []


def test_host_pool_slab_rows_hold_the_payload():
    """With a slab a stored payload IS its row's views (no private copy);
    a reservation never stored is an audit finding."""
    layout = tuple((tuple(p.shape), p.dtype.str) for p in _payload(0))
    nbytes = sum(p.nbytes for p in _payload(0))
    pool = HostPagePool(2, np.zeros((2, nbytes), np.uint8), layout)
    hid = pool.store(_payload(1))
    got = pool.load(hid)
    assert all(np.shares_memory(g, pool.slab) for g in got)
    assert all(np.array_equal(g, w) for g, w in zip(got, _payload(1)))
    pool.reserve()
    assert "reserved but never stored" in " ".join(pool.audit())


# -- DiskPageStore ----------------------------------------------------------


def test_disk_store_round_trip_bitwise(tmp_path):
    store = DiskPageStore(str(tmp_path))
    p = _payload(0)
    ref = store.store(p)
    got = store.load(ref)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in zip(got, p))
    assert store.audit() == []
    store.free(ref)
    assert not store.live(ref)


def test_disk_store_crc_corruption_loads_none(tmp_path):
    store = DiskPageStore(str(tmp_path))
    ref = store.store(_payload(1))
    path, off = ref[0], ref[1]
    with open(path, "r+b") as fh:
        fh.seek(off + 5)
        byte = fh.read(1)
        fh.seek(off + 5)
        fh.write(bytes([byte[0] ^ 0xFF]))
    assert store.load(ref) is None  # damage -> None, never wrong bytes
    assert store.crc_failures == 1
    assert store.audit() != []  # the audit's read-back flags it too


def test_disk_store_budget_and_dead_segment_reclaim(tmp_path):
    store = DiskPageStore(str(tmp_path), budget_bytes=3000)
    small = (np.zeros(256, np.float32),)  # 1024 B records
    r1, r2 = store.store(small), store.store(small)
    assert store.store(small) is None  # budget: 3072 > 3000
    store.free(r1)
    r3 = store.store(small)
    assert r3 is not None
    store.SEGMENT_BYTES = 1  # every store from now on seals + rotates
    store.free(r3)
    r4 = store.store(small)
    assert r4 is not None and r4[0] != r2[0]  # rotated
    seg1 = r2[0]
    store.free(r2)  # last live record of segment 1 dies
    assert not os.path.exists(seg1)
    assert store.live(r4) and store.audit() == []


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_disk_segments_cross_the_packages(tmp_path, writer):
    """One package writes segments and sidecars; the other's store loads
    every record bitwise and its sidecar reader verifies them."""
    from distributed_llama_tpu.io import stream as ref_stream
    from distributed_llama_tpu_torch.io import stream

    make = {"port": DiskPageStore, "jax": ref_paging.DiskPageStore}
    other = "jax" if writer == "port" else "port"
    src = make[writer](str(tmp_path / "w"))
    src.SEGMENT_BYTES = 2048  # two records a segment: sealed sidecars
    payloads = [_payload(i) for i in range(5)]
    refs = [src.store(p) for p in payloads]
    assert src.audit() == []  # flushes the live segment's sidecar too
    dst = make[other](str(tmp_path / "r"))
    for ref, p in zip(refs, payloads):
        got = dst.load(ref)
        assert all(a.tobytes() == b.tobytes() for a, b in zip(got, p))
    reader = ref_stream if other == "jax" else stream
    for path in sorted({r[0] for r in refs}):
        ok = set(reader.verified_ranges(path))
        assert {(r[1], r[2]) for r in refs if r[0] == path} <= ok


# -- strict LRU and round trips ---------------------------------------------


def test_demotion_order_is_strict_lru():
    """Per-touch monotonic ticks: demotion victims leave in exact recency
    order, the JAX allocator's order, even when published in one insert."""
    orders = []
    for mod in (ref_paging, None):
        alloc = (mod.PagedAllocator(8, 2, host_pages=8) if mod
                 else PagedAllocator(8, 2, host_pages=8))
        order = []

        def fetch(pid, order=order):
            order.append(pid)
            return (np.full((1,), pid, np.float32),)

        alloc.bind_device_io(fetch)
        pages = [alloc.alloc_page() for _ in range(3)]
        alloc.insert_prefix([1, 2, 3, 4, 5, 6], pages)
        alloc.release_pages(pages)
        got = alloc.match_prefix([1, 2, 3, 4])  # refresh the first chain
        alloc.release_pages(got)
        alloc.demote_cold(3)
        assert order == [pages[2], pages[0], pages[1]]
        assert alloc.audit([]) == []
        orders.append(order)
    assert orders[0] == orders[1]


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_demote_promote_round_trip_bitwise(tmp_path, tier):
    """HBM -> host or disk -> HBM moves the exact page bytes: the staged
    promotion payload is bit-identical to what demotion fetched."""
    kw = ({"host_pages": 1} if tier == "host"
          else {"disk_dir": str(tmp_path)})
    alloc = PagedAllocator(2, 2, **kw)
    payloads = {}

    def fetch(pid):
        payloads[pid] = _payload(100 + pid)
        return payloads[pid]

    alloc.bind_device_io(fetch)
    pages = [alloc.alloc_page()]
    alloc.insert_prefix([1, 2], pages)
    alloc.release_pages(pages)
    alloc.demote_cold(1)
    assert alloc.tier_page_counts()[tier] == 1
    got = alloc.match_prefix([1, 2])
    (job,) = alloc.take_staged_promotions()
    assert all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in zip(job.staged, payloads[pages[0]]))
    alloc.promotion_applied(job)
    alloc.release_pages(got)
    assert alloc.promotions[tier] == 1 and alloc.audit([]) == []


def test_page_io_round_trip_through_the_pool(params, tmp_path):
    """The engine's device half on the CPU: a pool page demoted into a host
    row and promoted into another page lands bitwise (f32) and
    code-exact (Q8), the JAX fetch_page_planes layout."""
    import torch

    from distributed_llama_tpu_torch.models.llama import (
        fetch_page_planes, init_cache_paged, init_cache_paged_q8,
        write_page_planes)
    from distributed_llama_tpu_torch.runtime.kv_io import PageIO

    spec = _port_spec()
    gen = torch.Generator().manual_seed(0)
    for cache in (init_cache_paged(spec, 5, PS, "cpu"),
                  init_cache_paged_q8(spec, 5, PS, "cpu")):
        for plane in cache:
            plane.copy_((torch.randn(plane.shape, generator=gen) * 50)
                        .to(plane.dtype))
        io = PageIO(cache, "cpu", host_pages=2)
        alloc = PagedAllocator(4, PS, host_pages=2, host_slab=io.slab,
                               host_layout=io.layout)
        alloc.bind_device_io(io.fetch, stage=io.stage_inline,
                             fetch_into=io.fetch_into)
        want = fetch_page_planes(cache, 1)
        pages = [alloc.alloc_page()]  # page 1
        alloc.insert_prefix(list(range(PS)), pages)
        alloc.release_pages(pages)
        alloc.demote_cold(1)
        assert np.shares_memory(alloc.host.load(0)[0], io.slab)
        write_page_planes(cache, 1, [np.zeros_like(w) for w in want])
        got = alloc.match_prefix(list(range(PS)) + [0])
        assert io.settle(alloc) and not alloc.slot_pending(got)
        back = fetch_page_planes(cache, got[0])
        assert all(a.tobytes() == b.tobytes() for a, b in zip(want, back))
        alloc.release_pages(got)
        assert alloc.audit([]) == []


# -- engine streams ---------------------------------------------------------


@pytest.mark.parametrize("kv_quant", ["f32", "q8"])
@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_engine_streams_invisible_to_tiering(params, tmp_path, kv_quant,
                                             temp):
    """A three-tier port engine under spill churn emits the streams of an
    all-HBM one and of the JAX three-tier engine; greedy, both staging
    inline (kv_tier_async=False: no uploader timing in the schedule),
    with the JAX engine's tier books."""
    w1, w2 = _waves(8)
    kw = dict(kv_quant=kv_quant, temperature=temp)
    inline = dict(kv_tier_async=temp != 0.0)
    ref = _two_waves(_engine(params, kv_pages=64, **kw), w1, w2)
    eng = _engine(params, kv_pages=8, kv_host_pages=6,
                  kv_disk_dir=str(tmp_path / "p"), **inline, **kw)
    got = _two_waves(eng, w1, w2)
    jax = _engine(params, jax=True, kv_pages=8, kv_host_pages=6,
                  kv_disk_dir=str(tmp_path / "j"), **inline, **kw)
    want = _two_waves(jax, w1, w2)
    eng.close()
    a, j = eng.allocator, jax.allocator
    assert got == ref == want
    assert sum(a.demotions.values()) > 0 and sum(a.promotions.values()) > 0
    assert (a.tokens_saved_by_tier[TIER_HOST]
            + a.tokens_saved_by_tier[TIER_DISK]) > 0
    if temp == 0.0:  # the same schedule: the same tier books
        for name in ("demotions", "promotions", "tokens_saved_by_tier",
                     "evictions", "prefix_hits"):
            assert getattr(a, name) == getattr(j, name), name
    assert eng.audit_pages() == []


def test_bf16_pool_tiers_bitwise(params, tmp_path):
    import torch

    w1, w2 = _waves(6)
    ref = _two_waves(_engine(params, kv_pages=64,
                             cache_dtype=torch.bfloat16), w1, w2)
    eng = _engine(params, kv_pages=8, kv_host_pages=6,
                  kv_disk_dir=str(tmp_path), cache_dtype=torch.bfloat16)
    assert _two_waves(eng, w1, w2) == ref
    assert sum(eng.allocator.promotions.values()) > 0
    assert eng.page_io.layout[0][1] == "<i2"  # bf16 words on the wire
    assert eng.audit_pages() == []


def test_disk_crc_corruption_rederives_via_prefill(params, tmp_path):
    """A CRC-damaged disk page degrades to recompute: the hit falls back
    to prefill, streams stay right, and the audit is clean after."""
    w1, w2 = _waves(6)
    ref = _two_waves(_engine(params, kv_pages=64), w1, w2)
    eng = _engine(params, kv_pages=8, kv_disk_dir=str(tmp_path))
    t1, _ = eng.run(w1, steps=16)
    a = eng.allocator
    assert a.tier_page_counts()[TIER_DISK] > 0
    for (path, off), length in list(a.disk._live.items()):
        with open(path, "r+b") as fh:
            fh.seek(off + length // 2)
            byte = fh.read(1)
            fh.seek(off + length // 2)
            fh.write(bytes([byte[0] ^ 0xFF]))
    t2, _ = eng.run(w2, steps=16)
    assert (t1, t2) == ref
    assert a.crc_drops > 0
    assert eng.audit_pages() == []


def test_admission_pauses_until_promotion_lands(params, tmp_path):
    """Hold the uploader's gate: a request whose shared prefix is being
    promoted from disk rides dispatches masked inactive (pauses move, no
    token is sampled) and resumes with the all-HBM stream once the
    upload lands."""
    from distributed_llama_tpu_torch.runtime.continuous import Request

    prefix = [1] + [11 + j for j in range(2 * PS)]
    (want,), _ = _engine(params, kv_pages=64).run([prefix + [99]],
                                                  steps=16)
    eng = _engine(params, kv_pages=8, kv_disk_dir=str(tmp_path))
    eng.run([prefix + [42]], steps=16)  # publish the prefix
    assert eng.allocator.demote_cold(2) == 2  # spill it
    gate = threading.Event()  # held: staging stalls
    eng._uploader.gate = gate
    req = Request(tokens=prefix + [99], steps=16)
    eng.submit(req)
    pauses0 = eng.stats.pauses
    for _ in range(3):
        eng.step_once()
    assert not req.done.is_set()
    assert eng.stats.pauses > pauses0
    assert req.n_sampled == 0
    slot = next(s for s in eng._pool if s.req is req)
    assert slot.await_promo and eng.allocator.slot_pending(slot.pages)
    gate.set()
    for _ in range(200):
        if eng.step_once() == 0:
            break
    assert req.done.is_set() and req.error is None
    assert req.out == want
    assert eng.allocator.promotions[TIER_DISK] >= 2
    assert eng.stats.promo_waits == 1 and eng.stats.promo_wait_s > 0
    assert eng.audit_pages() == []
    eng.close()


def test_savings_hold_at_10x_hbm_working_set(params, tmp_path):
    """20 prefixes x 2 pages against an 8-page pool: tiered savings within
    20% of the all-HBM ceiling and equal to the JAX tiered engine's (both
    staging inline); the drop baseline saves next to nothing."""
    w1, w2 = _waves(20)
    ref = _engine(params, kv_pages=64)
    _two_waves(ref, w1, w2, reset=True)
    ceiling = ref.allocator.tokens_saved
    assert ceiling == 20 * 2 * PS
    saved = []
    for jax, d in ((False, "p"), (True, "j")):
        eng = _engine(params, jax=jax, kv_pages=8, kv_host_pages=10,
                      kv_disk_dir=str(tmp_path / d), kv_tier_async=False)
        _two_waves(eng, w1, w2, reset=True)
        saved.append(eng.allocator.tokens_saved)
        assert eng.audit_pages() == []
        eng.close()
    assert saved[0] == saved[1] >= 0.8 * ceiling
    drop = _engine(params, kv_pages=8)
    _two_waves(drop, w1, w2, reset=True)
    assert drop.allocator.tokens_saved <= 0.2 * ceiling


# -- observability and knobs ------------------------------------------------


def _sample(text, name):
    for line in text.splitlines():
        if line.startswith(name) and not line.startswith("#"):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"{name} not exposed")


def test_tier_metrics_exposition_and_counters(params, tmp_path):
    from distributed_llama_tpu_torch.obs.metrics import Registry

    reg = Registry()
    eng = _engine(params, kv_pages=8, kv_host_pages=6,
                  kv_disk_dir=str(tmp_path), metrics=reg)
    _two_waves(eng, *_waves(8))
    text = reg.expose()
    assert 'dllama_kv_tier_pages{tier="host"}' in text
    assert 'dllama_prefill_tokens_saved_by_tier_total{tier="disk"}' in text
    a = eng.allocator
    assert _sample(text, "dllama_tier_promotions_total") == sum(
        a.promotions.values())
    assert _sample(text, "dllama_tier_demotions_total") == sum(
        a.demotions.values())
    census = eng.sched_census.tail(64)
    assert any("tier_pages" in r for r in census)


def test_untiered_engine_exposes_tier_series_flat(params):
    from distributed_llama_tpu_torch.obs.metrics import Registry

    reg = Registry()
    eng = _engine(params, kv_pages=16, metrics=reg)
    eng.run(_waves(3)[0], steps=12)
    text = reg.expose()
    assert "dllama_tier_promotions_total 0" in text
    assert "dllama_tier_demotions_total 0" in text
    assert eng.page_io is None


@pytest.mark.parametrize("kw,match", [
    ({"page_size": 0, "kv_host_pages": 4}, "kv-page-size"),
    ({"kv_disk_bytes": 1 << 20}, "kv_disk_dir")])
def test_tier_knobs_require_paged_cache(params, kw, match):
    for jax in (True, False):
        with pytest.raises(ValueError, match=match):
            _engine(params, jax=jax, **kw)


def test_generate_continuous_prints_the_tier_line(params, tmp_path, capsys):
    """The CLI entry's KV tiers line equals the JAX one."""
    from distributed_llama_tpu.io.tokenizer import Tokenizer as RefTok
    from distributed_llama_tpu.io.tokenizer import write_tokenizer
    from distributed_llama_tpu.runtime.continuous import \
        generate_continuous as ref_gen
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.runtime.continuous import \
        generate_continuous

    pieces = [b"<unk>", b"<s>", b"</s>"]
    pieces += [f"<0x{i:02X}>".encode() for i in range(256)]
    pieces = pieces[:SPEC.vocab_size - 2] + [b"a", b"b"]
    tok = str(tmp_path / "tok.bin")
    write_tokenizer(tok, pieces, [0.0] * len(pieces))
    prompts = [f"{'ab' * 5}{c}" for c in "abababab"] * 2
    kw = dict(slots=2, page_size=PS, prefill_chunk=PS, kv_pages=6,
              kv_host_pages=3)

    def tier(out):
        return [ln for ln in out.splitlines()
                if ln.startswith(("KV tiers", "["))]

    ref_gen(SPEC, params[0], RefTok(tok, SPEC.vocab_size), prompts, 20,
            0.0, 0.9, 1, use_native_sampler=False,
            kv_disk_dir=str(tmp_path / "j"), **kw)
    want = tier(capsys.readouterr().out)
    generate_continuous(_port_spec(), params[1], Tokenizer(tok,
                        SPEC.vocab_size), prompts, 20, 0.0, 0.9, 1,
                        device="cpu", kv_disk_dir=str(tmp_path / "p"), **kw)
    got = tier(capsys.readouterr().out)
    assert got == want and got[-1].startswith("KV tiers:")


# -- recovery ---------------------------------------------------------------


def test_recovery_promotes_disk_resident_prefix_bitwise(params, tmp_path):
    """A recovered request whose shared prefix sits on DISK promotes it
    through the same async path as a live admission, and the continued
    stream is the uninterrupted run's."""
    from distributed_llama_tpu_torch.runtime.continuous import Request
    from distributed_llama_tpu_torch.runtime.journal import RequestJournal

    prefix = [1, 9, 17, 25, 2, 4, 6, 8]  # two full pages at ps=4
    kw = dict(temperature=0.8, seed=11)
    tiered = dict(kv_pages=8, kv_disk_dir=str(tmp_path / "kv"), **kw)

    def drain(e):
        while e.step_many(e.block_steps, quiet=True):
            pass

    def victim():
        return Request(tokens=list(prefix) + [3], steps=24,
                       temperature=0.9, topp=0.9, seed=502)

    def warm(e):
        e.submit(Request(tokens=list(prefix) + [7], steps=24,
                         temperature=0.0, topp=0.9, seed=501))
        drain(e)
        assert e.allocator.demote_cold(2) == 2
        assert e.allocator.tier_page_counts()[TIER_DISK] > 0

    ref_eng = _engine(params, kv_pages=24, **kw)
    ref_req = ref_eng.submit(victim())
    drain(ref_eng)
    path = str(tmp_path / "j.journal")
    eng = _engine(params, journal=RequestJournal(path), **tiered)
    warm(eng)
    v = eng.submit(victim())
    for _ in range(6):
        eng.step_many(eng.block_steps, quiet=True)
    assert not v.done.is_set() and v.n_sampled >= 2
    eng.close()
    # a fresh process: re-publish and spill the prefix, then recover
    eng2 = _engine(params, journal=RequestJournal(path), **tiered)
    warm(eng2)
    assert eng2.recover() == 1
    with eng2._lock:
        (rec,) = list(eng2._queue)
    drain(eng2)
    assert rec.out == ref_req.out
    assert eng2.allocator.promotions[TIER_DISK] > 0
    assert eng2.audit_pages() == []
    eng2.close()


def test_fingerprint_kv_tier_keys(params, tmp_path):
    """The tier keys of the config fingerprint are the JAX package's:
    omitted when off, and a changed tier budget under live work refuses
    with the key named."""
    from distributed_llama_tpu.runtime.journal import \
        config_fingerprint as ref_fp
    from distributed_llama_tpu_torch.runtime.continuous import Request
    from distributed_llama_tpu_torch.runtime.journal import (
        JournalConfigMismatch, RequestJournal, config_fingerprint)

    spec = _port_spec()

    def fp(**kw):
        got = config_fingerprint(spec, "single", "explicit:11",
                                 weights_digest="abcd", **kw)
        assert got == ref_fp(SPEC, "single", "explicit:11",
                             weights_digest="abcd", **kw)
        return got

    assert "kv_host_pages" not in fp() and "kv_disk" not in fp()
    path = str(tmp_path / "j")
    eng = _engine(params, journal=RequestJournal(
        path, config=fp(kv_host_pages=64, kv_disk=True)))
    eng.submit(Request(tokens=[1, 9, 17, 25], steps=24))
    eng.step_many(1, quiet=True)
    for cfg, key in ((fp(kv_host_pages=128, kv_disk=True), "kv_host_pages"),
                     (fp(), "kv_disk")):
        with pytest.raises(JournalConfigMismatch, match=key):
            _engine(params, journal=RequestJournal(path,
                                                   config=cfg)).recover()
