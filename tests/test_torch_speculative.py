"""Speculative decoding in the port (runtime/speculative.py, the verify
forward ``Llama.forward_batch_spec_paged`` and ``ContinuousEngine(spec_k=)``)
against the JAX package, on the CPU (the kernels' plain versions):

* ``draft_tokens``, ``effective_probs`` and ``accept_or_resample`` equal the
  JAX package's on seeded histories, logits and coin streams (same token,
  same accepted flag, the same coins drawn);
* the verify forward's logits equal K sequential ``forward_batch_paged``
  steps within 1e-5 x max|logits| (f32 and Q40 weights; not bit for bit:
  ``F.linear`` at M = B*K rows against M = B rows may sum in another
  order), and a window that runs past the virtual plane writes its tail to
  the scrap page only;
* greedy spec-on streams equal the spec-off streams and the JAX engine's
  spec-on streams over f32 and Q8 pages (a GQA model: 4 query heads over
  2 kv heads); seeded sampled streams equal the JAX engine's; the draft
  and accept counts equal the JAX engine's;
* ``_trim_pages`` leaves the JAX engine's page counts and a clean audit;
* the engine's argument checks raise the JAX engine's messages.

The JAX engine's streams are computed once per configuration (module
cache): its engine builds are this file's cost."""

import functools

import numpy as np
import pytest
import torch

from distributed_llama_tpu.models.spec import TransformerSpec
from distributed_llama_tpu.models.synth import synth_params
from distributed_llama_tpu.ops.quants import FloatType

SPEC = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                       n_kv_heads=2, vocab_size=128, seq_len=64,
                       weights_float_type=FloatType.Q40)
SPEC_F32 = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=128, seq_len=64,
                           weights_float_type=FloatType.F32)
_FIELDS = ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads",
           "vocab_size", "seq_len", "weights_float_type")
K, PS, SLOTS, STEPS = 4, 4, 3, 48
LOGIT_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's small CPU forwards: under
    xdist, workers whose thread pools oversubscribe the cores ran them
    ~10x slower than one thread does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_spec(spec):
    from distributed_llama_tpu_torch.models.spec import TransformerSpec as PS_
    from distributed_llama_tpu_torch.ops.quants import FloatType as PFT

    kw = {f: getattr(spec, f) for f in _FIELDS}
    kw["weights_float_type"] = PFT(int(spec.weights_float_type))
    return PS_(**kw)


def _host(params):
    from distributed_llama_tpu_torch.io.loader import Q40Weight

    return {k: (Q40Weight(np.asarray(v.qs), np.asarray(v.d16))
                if hasattr(v, "qs") else np.asarray(v))
            for k, v in params.items()}


@functools.lru_cache(maxsize=None)
def _params(q40=True):
    spec = SPEC if q40 else SPEC_F32
    params = synth_params(spec, q40=q40, seed=4, scale=0.3)
    return params, _host(params)


def _requests():
    """Prompts that share an 8-token prefix and repeat short phrases, so
    the drafter finds n-grams to copy."""
    rng = np.random.default_rng(5)
    prefix = [1, *rng.integers(3, SPEC.vocab_size, 7)]
    phrase = list(rng.integers(3, SPEC.vocab_size, 3))
    return [prefix + phrase * r + list(rng.integers(3, SPEC.vocab_size, k))
            for r, k in ((1, 2), (2, 1), (0, 5), (3, 3), (1, 6))]


@functools.lru_cache(maxsize=None)
def _jax_run(temperature, kv_quant="f32", spec_k=K):
    """The JAX engine's streams, stats and page state, once per
    configuration."""
    from distributed_llama_tpu.runtime.continuous import \
        ContinuousEngine as Ref

    params, _ = _params()
    ref = Ref(SPEC, params, SLOTS, temperature, 0.9, 7, page_size=PS,
              kv_quant=kv_quant, spec_k=spec_k, use_native_sampler=False)
    outs, st = ref.run(_requests(), STEPS)
    a = ref.allocator
    return outs, (st.tokens, st.steps, st.spec_proposed, st.spec_accepted,
                  st.pauses), (a.n_free, a.prefix_hits, a.evictions,
                               ref.audit_pages())


def _port_engine(temperature, **kw):
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine

    _, host = _params()
    return ContinuousEngine(_port_spec(SPEC), host, SLOTS, temperature, 0.9,
                            7, page_size=PS, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the host helpers
# ---------------------------------------------------------------------------

def test_draft_tokens_equals_jax():
    from distributed_llama_tpu.runtime import speculative as ref
    from distributed_llama_tpu_torch.runtime import speculative as port

    rng = np.random.default_rng(0)
    hits = 0
    for case in range(300):
        n = int(rng.integers(0, 40))
        history = list(rng.integers(0, int(rng.integers(2, 9)), n))
        k = int(rng.integers(0, 6))
        max_n = int(rng.integers(1, 5))
        want = ref.draft_tokens(history, k, max_n=max_n)
        got = port.draft_tokens(history, k, max_n=max_n)
        assert got == want, (case, history, k, max_n)
        hits += bool(got)
    assert hits > 100


@pytest.mark.parametrize("temperature,topp", [
    (0.8, 0.9), (1.0, 1.0), (0.5, 0.0), (1.3, 0.5), (0.7, 0.005)])
def test_effective_probs_equals_jax(temperature, topp):
    from distributed_llama_tpu.runtime import speculative as ref
    from distributed_llama_tpu_torch.runtime import speculative as port

    rng = np.random.default_rng(1)
    for _ in range(20):
        logits = (rng.standard_normal(97) * 3).astype(np.float32)
        want = ref.effective_probs(logits, temperature, topp)
        got = port.effective_probs(logits, temperature, topp)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("temperature,topp", [(0.8, 0.9), (1.0, 1.0),
                                              (0.3, 0.5)])
def test_accept_or_resample_equals_jax(temperature, topp):
    """Same token, same accepted flag, and the same coins drawn: both
    samplers' streams stand at the same state after every call."""
    from distributed_llama_tpu.runtime import speculative as ref
    from distributed_llama_tpu.runtime.sampling import Sampler as RefSampler
    from distributed_llama_tpu_torch.runtime import speculative as port
    from distributed_llama_tpu_torch.runtime.sampling import Sampler

    rng = np.random.default_rng(2)
    ours = Sampler(64, temperature, topp, 123)
    theirs = RefSampler(64, temperature, topp, 123, use_native=False)
    accepted = rejected = 0
    for _ in range(200):
        logits = (rng.standard_normal(64) * 2).astype(np.float32)
        probs = ref.effective_probs(logits, temperature, topp)
        # drafts from likely and unlikely tokens alike
        draft = int(np.argmax(probs) if rng.random() < 0.5
                    else rng.integers(0, 64))
        want = ref.accept_or_resample(logits, draft, theirs)
        got = port.accept_or_resample(logits, draft, ours)
        assert got == want
        assert ours.rng.state == theirs.rng.state
        accepted += got[1]
        rejected += not got[1]
    assert accepted > 20 and rejected > 20


# ---------------------------------------------------------------------------
# the verify forward
# ---------------------------------------------------------------------------

def _pool(spec, q8=False):
    from distributed_llama_tpu_torch.models.llama import (
        init_cache_paged, init_cache_paged_q8)

    n_pages = 3 * (spec.seq_len // PS) + 1
    return (init_cache_paged_q8(spec, n_pages, PS, "cpu") if q8
            else init_cache_paged(spec, n_pages, PS, "cpu"))


def _table(spec, batch=3):
    """Row b's logical page j -> physical page 1 + j * batch + (batch-1-b):
    interleaved and reversed, never the scrap page."""
    mp = spec.seq_len // PS
    t = 1 + np.arange(mp)[None, :] * batch + (batch - 1
                                              - np.arange(batch))[:, None]
    return torch.from_numpy(t.astype(np.int32))


def _model(q40):
    from distributed_llama_tpu_torch.models.llama import (Llama,
                                                          params_to_device)

    spec = _port_spec(SPEC if q40 else SPEC_F32)
    return Llama(spec, params_to_device(_params(q40)[1], "cpu"))


def _sequential(model, cache, tokens, pos, table):
    """K forward_batch_paged steps: logits (B, K, vocab)."""
    out = []
    for i in range(tokens.shape[1]):
        out.append(model.forward_batch_paged(cache, tokens[:, i].clone(),
                                             pos + i, table))
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("weights", ["f32", "q40"])
def test_verify_forward_equals_sequential_steps(weights):
    model = _model(weights == "q40")
    spec = model.spec
    rng = np.random.default_rng(3)
    table = _table(spec)
    pos = torch.tensor([0, 5, 13], dtype=torch.int32)
    hist = torch.from_numpy(rng.integers(3, 120, (3, 16)))
    a, b = _pool(spec), _pool(spec)
    with torch.inference_mode():
        for cache in (a, b):  # a history below each row's clock
            for t in range(13):
                model.forward_batch_paged(cache, hist[:, t].clone(),
                                          torch.full((3,), t, dtype=torch.int32),
                                          table)
        toks = torch.from_numpy(rng.integers(3, 120, (3, K)))
        got = model.forward_batch_spec_paged(a, toks, pos, table)
        want = _sequential(model, b, toks, pos, table)
    assert got.shape == (3, K, spec.vocab_size)
    tol = LOGIT_RTOL * want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(a.k.numpy(), b.k.numpy(), rtol=0, atol=1e-5)


def test_budget_edge_window_writes_the_scrap_page():
    """A window from pos S-2 runs two positions past the virtual plane:
    those two land on the scrap page, nothing else moves but the row's
    two live positions, and queries 0-1 see what sequential steps see."""
    from distributed_llama_tpu_torch.runtime.paging import SCRAP_PAGE

    model = _model(True)
    spec = model.spec
    S = spec.seq_len
    table = _table(spec, 1)
    cache = _pool(spec)
    before = cache.k.clone()
    toks = torch.tensor([[5, 9, 11, 17]])
    pos = torch.tensor([S - 2], dtype=torch.int32)
    with torch.inference_mode():
        got = model.forward_batch_spec_paged(cache, toks, pos, table)
        want = _sequential(model, _pool(spec), toks[:, :2], pos, table)
    changed = {(int(p), int(o)) for _, p, o in
               torch.nonzero((cache.k != before).any(-1).any(-1))}
    last = int(table[0, -1])
    assert changed == {(last, PS - 2), (last, PS - 1), (SCRAP_PAGE, 0),
                       (SCRAP_PAGE, 1)}
    tol = LOGIT_RTOL * want.abs().max().item()
    np.testing.assert_allclose(got[:, :2].numpy(), want.numpy(), rtol=0,
                               atol=tol)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", ["f32", "q8"])
def test_greedy_spec_streams_equal_spec_off_and_jax(kv_quant):
    want, want_stats, want_pages = _jax_run(0.0, kv_quant)
    eng = _port_engine(0.0, kv_quant=kv_quant, spec_k=K)
    got, st = eng.run(_requests(), STEPS)
    off, _ = _port_engine(0.0, kv_quant=kv_quant).run(_requests(), STEPS)
    assert got == want == off
    assert (st.tokens, st.steps, st.spec_proposed, st.spec_accepted,
            st.pauses) == want_stats
    assert st.spec_accepted > 0 and st.steps < sum(map(len, got))
    a = eng.allocator
    assert (a.n_free, a.prefix_hits, a.evictions,
            eng.audit_pages()) == want_pages
    assert eng.audit_pages() == []


@pytest.mark.parametrize("kv_quant", ["f32", "q8"])
def test_seeded_spec_streams_equal_jax(kv_quant):
    want, want_stats, want_pages = _jax_run(0.8, kv_quant)
    eng = _port_engine(0.8, kv_quant=kv_quant, spec_k=K)
    got, st = eng.run(_requests(), STEPS)
    assert got == want
    assert (st.tokens, st.steps, st.spec_proposed, st.spec_accepted,
            st.pauses) == want_stats
    assert st.spec_proposed > 0
    assert eng.audit_pages() == []


def test_spec_k2_and_ngram_equal_jax():
    """The narrowest window (one draft) matches too."""
    want, want_stats, _ = _jax_run(0.0, "f32", 2)
    eng = _port_engine(0.0, spec_k=2)
    got, st = eng.run(_requests(), STEPS)
    assert got == want
    assert (st.tokens, st.steps, st.spec_proposed, st.spec_accepted,
            st.pauses) == want_stats


def test_trim_pages_leaves_the_twin_page_counts():
    """After every verify dispatch each live slot holds the JAX engine's
    pages: the two engines step side by side."""
    from distributed_llama_tpu.runtime.continuous import \
        ContinuousEngine as Ref
    from distributed_llama_tpu.runtime.continuous import Request as RefReq
    from distributed_llama_tpu_torch.runtime.continuous import Request

    params, _ = _params()
    ref = Ref(SPEC, params, SLOTS, 0.0, 0.9, 7, page_size=PS, spec_k=K,
              use_native_sampler=False)
    eng = _port_engine(0.0, spec_k=K)
    for r in _requests():
        ref.submit(RefReq(tokens=list(r), steps=STEPS))
        eng.submit(Request(tokens=list(r), steps=STEPS))
    released = []
    trim = eng._trim_pages

    def counted(s):
        n = len(s.pages)
        trim(s)
        released.append(n - len(s.pages))

    eng._trim_pages = counted
    while True:
        left = eng.step_many(1)
        assert ref.step_many(1) == left
        got = [len(s.pages) for s in eng._pool]
        assert got == [len(s.pages) for s in ref._pool]
        assert [s.pos for s in eng._pool] == [s.pos for s in ref._pool]
        assert eng.audit_pages() == []
        if not left:
            break
    assert eng.allocator.n_free == ref.allocator.n_free
    assert sum(released) > 0  # rejected windows gave pages back


@pytest.mark.parametrize("kw,match", [
    ({"spec_k": 1, "page_size": 4}, "K >= 2"),
    ({"spec_k": 4}, "spec_k requires the paged KV cache"),
    ({"spec_k": 4, "page_size": 4, "dispatch_tokens": 8},
     "incompatible with spec_k")])
def test_engine_checks_match_jax(kw, match):
    from distributed_llama_tpu.runtime.continuous import \
        ContinuousEngine as Ref
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine

    params, host = _params()
    with pytest.raises(ValueError, match=match) as ours:
        ContinuousEngine(_port_spec(SPEC), host, 2, 0.0, 0.9, 1,
                         device="cpu", **kw)
    with pytest.raises(ValueError, match=match) as theirs:
        Ref(SPEC, params, 2, 0.0, 0.9, 1, **kw)
    assert str(ours.value) == str(theirs.value)
