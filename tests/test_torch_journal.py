"""The port's write-ahead journal (runtime/journal.py) and its engine's
recovery against the JAX package's, on the CPU:

* a journal that the JAX engine suspended mid-stream is recovered by the
  port's engine, and one that the port suspended by the JAX engine; both
  continue every request to the stream an uninterrupted JAX engine gives
  it, token for token, greedy and seeded, on f32 pages with admission
  prefill and with speculative decoding (its accept and residual coins
  counted in the journaled cursor);
* the config fingerprint is JAX's dict for the same spec and flags, and a
  journal written under another config is refused by either package's
  recover (JournalConfigMismatch), in both directions;
* a torn tail is cut away on open, damage before the tail raises
  JournalCorruption, in both packages alike;
* the books the engine keeps (census totals, ledger counts) equal the
  JAX engine's over the same run.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_continuous import SPEC, _host, _port_spec

from distributed_llama_tpu.models.synth import synth_params


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    params = synth_params(SPEC, q40=True, seed=4, scale=0.3)
    return params, _host(params)


def _prompts():
    rng = np.random.default_rng(2)
    prefix = [1, *map(int, rng.integers(3, SPEC.vocab_size, 7))]
    return [prefix + [int(t) for t in rng.integers(3, SPEC.vocab_size, n)]
            for n in (1, 4, 2, 6)]


CASES = {"paged-chunk4": dict(page_size=4, prefill_chunk=4),
         "paged-spec4": dict(page_size=4, spec_k=4)}


def _pkg(name):
    if name == "jax":
        from distributed_llama_tpu.runtime import continuous, journal
    else:
        from distributed_llama_tpu_torch.runtime import continuous, journal
    return continuous, journal


def _engine(name, model, journal=None, **opts):
    continuous, _ = _pkg(name)
    params, host = model
    if name == "jax":
        return continuous.ContinuousEngine(SPEC, params, 2, 0.0, 0.9, 5,
                                           journal=journal, **opts)
    return continuous.ContinuousEngine(_port_spec(SPEC), host, 2, 0.0, 0.9,
                                       5, journal=journal, device="cpu",
                                       **opts)


def _requests(name, temperature):
    continuous, _ = _pkg(name)
    return [continuous.Request(tokens=list(p), steps=24,
                               temperature=temperature, topp=0.9,
                               seed=40 + i)
            for i, p in enumerate(_prompts())]


def _fingerprint(name, seed_policy="explicit:5"):
    _, journal = _pkg(name)
    spec = SPEC if name == "jax" else _port_spec(SPEC)
    return journal.config_fingerprint(spec, "single", seed_policy,
                                      weights_digest="0123456789abcdef")


def _drain(eng, reqs):
    while eng.step_many(eng.block_steps):
        pass
    assert all(r.done.is_set() and r.error is None for r in reqs)
    return [r.out for r in reqs]


@pytest.fixture(scope="module")
def uninterrupted(model):
    """The JAX engine's streams, run through without a journal."""
    out = {}
    for case, opts in CASES.items():
        for temp in (0.0, 0.8):
            eng = _engine("jax", model, **opts)
            reqs = [eng.submit(r) for r in _requests("jax", temp)]
            out[case, temp] = _drain(eng, reqs)
    return out


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "seeded"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_recovery_across_packages_continues_the_jax_stream(
        model, uninterrupted, tmp_path, first, second, temperature, case):
    opts = CASES[case]
    path = str(tmp_path / "j.wal")
    _, j1 = _pkg(first)
    eng = _engine(first, model, j1.RequestJournal(
        path, fsync="off", config=_fingerprint(first)), **opts)
    for r in _requests(first, temperature):
        eng.submit(r)
    for _ in range(5):  # partway: some sampled, some still queued
        eng.step_many(eng.block_steps)
    assert eng.suspend() > 0
    eng._journal.close()
    _, j2 = _pkg(second)
    journal = j2.RequestJournal(path, fsync="off",
                                config=_fingerprint(second))
    live = journal.incomplete()
    assert live and any(e.sampled for e in live)
    eng2 = _engine(second, model, journal, **opts)
    n = eng2.recover()
    assert n == len(live)
    while eng2.step_many(eng2.block_steps):
        pass
    journal.close()
    want = uninterrupted[case, temperature]
    prompts = _prompts()
    done = [e for e in j2.load_journal(path) if e.status == "done"]
    # every request's whole stream: its first life's finished one, or its
    # recovered life's (the replayed tokens echoed, then the rest)
    for i, p in enumerate(prompts):
        lives = [e for e in done if e.tokens[:len(p)] == p]
        assert len(lives) == 1, (i, lives)
        e = lives[0]
        assert e.tokens[1:] + e.sampled == want[i], (i, case)
    # the coin cursors moved only on sampled runs
    cursors = [e.cursor for e in j2.load_journal(path)]
    assert any(cursors) == (temperature > 0)


def test_config_fingerprint_is_the_jax_dict(tmp_path):
    from distributed_llama_tpu.runtime.journal import \
        weight_file_digest as jax_digest
    from distributed_llama_tpu_torch.runtime.journal import \
        weight_file_digest

    assert _fingerprint("port") == _fingerprint("jax")
    for kw in ({"kv_quant": "q8", "kv_cache_dtype": "bf16"},
               {"kv_host_pages": 8, "kv_disk": True}):
        from distributed_llama_tpu.runtime.journal import \
            config_fingerprint as jfp
        from distributed_llama_tpu_torch.runtime.journal import \
            config_fingerprint as pfp

        assert (pfp(_port_spec(SPEC), "fused", "time", **kw)
                == jfp(SPEC, "fused", "time", **kw))
    blob = tmp_path / "w.bin"
    blob.write_bytes(np.random.default_rng(0).bytes(3 << 20))
    assert weight_file_digest(str(blob)) == jax_digest(str(blob))


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_a_config_mismatch_refuses_recovery(model, tmp_path, first, second):
    path = str(tmp_path / "j.wal")
    _, j1 = _pkg(first)
    eng = _engine(first, model, j1.RequestJournal(
        path, fsync="off", config=_fingerprint(first)), page_size=4)
    for r in _requests(first, 0.0):
        eng.submit(r)
    eng.step_many(1)
    eng.suspend()
    eng._journal.close()
    _, j2 = _pkg(second)
    journal = j2.RequestJournal(path, fsync="off",
                                config=_fingerprint(second, "explicit:6"))
    eng2 = _engine(second, model, journal, page_size=4)
    with pytest.raises(j2.JournalConfigMismatch, match="seed_policy"):
        eng2.recover()


def _write(path, records, tail=b""):
    with open(path, "wb") as f:
        for rec in records:
            f.write(json.dumps(rec, separators=(",", ":")).encode() + b"\n")
        f.write(tail)


RECORDS = [{"t": "journal", "v": 1},
           {"t": "admit", "id": 0, "tokens": [1, 5], "steps": 8,
            "temperature": 0.0, "topp": 0.9, "seed": 3, "slo": None,
            "cursor": 0},
           {"t": "tok", "id": 0, "tok": 9, "cursor": 0}]


@pytest.mark.parametrize("tail", [b'{"t":"tok","id":0,"to', b"{}\n",
                                  b'{"t":"tok","id":0,"tok":4,"cursor":0}'],
                         ids=["torn", "schema-torn", "unterminated"])
def test_a_torn_tail_is_cut_as_in_jax(tmp_path, tail):
    from distributed_llama_tpu.runtime.journal import \
        RequestJournal as JaxJournal
    from distributed_llama_tpu_torch.runtime.journal import RequestJournal

    sizes, lives = [], []
    for cls, name in ((JaxJournal, "jax"), (RequestJournal, "port")):
        path = tmp_path / f"{name}.wal"
        _write(path, RECORDS, tail)
        j = cls(str(path), fsync="off")
        lives.append([(e.rid, e.sampled) for e in j.incomplete()])
        j.close()
        sizes.append(path.stat().st_size)
    assert sizes[0] == sizes[1] < sum(
        len(json.dumps(r, separators=(",", ":"))) + 1 for r in RECORDS) \
        + len(tail)
    assert lives[0] == lives[1] == [(0, [9])]


@pytest.mark.parametrize("bad", [
    [RECORDS[0], {"t": "tok", "id": 7, "tok": 1, "cursor": 0}, RECORDS[1]],
    [{"t": "nope"}, RECORDS[1]],
    [RECORDS[0], RECORDS[1], {"t": "retire", "id": 0, "status": "odd"},
     RECORDS[2]]], ids=["unadmitted", "header", "status"])
def test_damage_before_the_tail_raises(tmp_path, bad):
    from distributed_llama_tpu.runtime.journal import \
        JournalCorruption as JaxCorruption
    from distributed_llama_tpu.runtime.journal import \
        RequestJournal as JaxJournal
    from distributed_llama_tpu_torch.runtime.journal import (
        JournalCorruption, RequestJournal)

    path = tmp_path / "j.wal"
    for cls, exc in ((JaxJournal, JaxCorruption),
                     (RequestJournal, JournalCorruption)):
        _write(path, bad)
        with pytest.raises(exc) as ei:
            cls(str(path), fsync="off")
        msgs = str(ei.value)
        assert "line" in msgs or "header" in msgs


def test_the_books_equal_the_jax_engine(model):
    """Census totals and ledger counts over the same run (speculative, so
    the spec tokens and drafts are booked too)."""
    books = {}
    for name in ("jax", "port"):
        eng = _engine(name, model, page_size=4, spec_k=4)
        reqs = [eng.submit(r) for r in _requests(name, 0.0)]
        _drain(eng, reqs)
        book = eng.ledger_book
        books[name] = (eng.sched_census.totals(),
                       (book.opened_n, book.closed_n, book.n_open),
                       {k: v for k, v in book.grand_totals().items()
                        if not k.endswith("_s")})
    assert books["port"] == books["jax"]
    assert books["port"][0]["tokens"]["spec"] > 0
