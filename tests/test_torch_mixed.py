"""Token-budget mixed dispatch in the port (``Llama.forward_batch_mixed_paged``
and ``ContinuousEngine(dispatch_tokens=)``) against the JAX package, on the
CPU (the kernels' plain versions); the twin of tests/test_mixed_batch.py:

* with every span full the mixed forward is the verify forward bit for bit
  (logits and pool), f32 and Q40 weights;
* a window with every span 1 gives the plain decode step's logits in its
  first column (within 1e-5 x max|logits|: ``F.linear`` at M = B*T rows
  against M = B rows may sum in another order) and moves nothing but the
  decode positions and the scrap page;
* offsets past a row's span write to the scrap page only;
* streams at budgets 2, 4, 8 and 16, greedy and seeded, equal the
  separate-dispatch engine's (admission prefill at chunk 4) and the JAX
  engine's with the same budget; over Q8 pages; a prefill-only tail with
  no active decode rows; the auto budget (-1) and the floor at 2; the
  exclusion with spec_k.

The JAX engine's streams are computed once per configuration (module
cache)."""

import functools

import numpy as np
import pytest
import torch

from distributed_llama_tpu.models.spec import TransformerSpec
from distributed_llama_tpu.models.synth import synth_params
from distributed_llama_tpu.ops.quants import FloatType

SPEC = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                       n_kv_heads=2, vocab_size=128, seq_len=32,
                       weights_float_type=FloatType.F32)
SPEC_Q40 = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=128, seq_len=32,
                           weights_float_type=FloatType.Q40)
_FIELDS = ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads",
           "vocab_size", "seq_len", "weights_float_type")
PS = 4
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


@functools.lru_cache(maxsize=None)
def _params(q40=False):
    from distributed_llama_tpu_torch.io.loader import Q40Weight

    spec = SPEC_Q40 if q40 else SPEC
    params = synth_params(spec, q40=q40, seed=4, scale=0.3)
    host = {k: (Q40Weight(np.asarray(v.qs), np.asarray(v.d16))
                if hasattr(v, "qs") else np.asarray(v))
            for k, v in params.items()}
    return params, host


def _reqs(n=6, seed=11):
    """The twin's requests: BOS and 2..13 random tokens each."""
    rng = np.random.default_rng(seed)
    return [[1] + list(rng.integers(3, 120, rng.integers(2, 14)))
            for _ in range(n)]


def _opts(kw):
    return dict(slots=kw.pop("slots", 4),
                temperature=kw.pop("temperature", 0.0),
                kv_pages=kw.pop("kv_pages", 32)), kw


@functools.lru_cache(maxsize=None)
def _jax(reqs, steps, items):
    """The JAX engine's streams and stats for ``items`` (a sorted tuple of
    engine options), once per configuration."""
    from distributed_llama_tpu.runtime.continuous import \
        ContinuousEngine as Ref

    o, kw = _opts(dict(items))
    ref = Ref(SPEC, _params()[0], o["slots"], o["temperature"], 0.9, 7,
              page_size=PS, kv_pages=o["kv_pages"], use_native_sampler=False,
              **kw)
    outs, st = ref.run([list(r) for r in reqs], steps)
    return outs, (st.tokens, st.steps, st.pauses, st.overrun_steps)


def _port(reqs, steps, **kw):
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine

    o, kw = _opts(kw)
    eng = ContinuousEngine(_port_spec(SPEC), _params()[1], o["slots"],
                           o["temperature"], 0.9, 7, page_size=PS,
                           kv_pages=o["kv_pages"], device="cpu", **kw)
    outs, st = eng.run([list(r) for r in reqs], steps)
    return eng, outs, st


def _both(reqs, steps, **kw):
    """(port engine, its streams, its stats) and the JAX engine's streams
    and stats under the same options."""
    key = tuple(map(tuple, reqs))
    want = _jax(key, steps, tuple(sorted(kw.items())))
    return _port(reqs, steps, **kw), want


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def _model(q40=False):
    from distributed_llama_tpu_torch.models.llama import (Llama,
                                                          params_to_device)

    return Llama(_port_spec(SPEC_Q40 if q40 else SPEC),
                 params_to_device(_params(q40)[1], "cpu"))


def _pool(spec, batch):
    from distributed_llama_tpu_torch.models.llama import init_cache_paged

    return init_cache_paged(spec, batch * (spec.seq_len // PS) + 1, PS,
                            "cpu")


def _table(spec, batch):
    """The twin's table: row b's logical page j at 1 + j * B + b."""
    mp = spec.seq_len // PS
    t = 1 + np.arange(mp)[None, :] * batch + np.arange(batch)[:, None]
    return torch.from_numpy(t.astype(np.int32))


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


@pytest.mark.parametrize("weights", ["f32", "q40"])
def test_full_span_mixed_is_the_verify_forward(weights):
    model = _model(weights == "q40")
    spec, B, T = model.spec, 2, 3
    a, b = _pool(spec, B), _pool(spec, B)
    table = _table(spec, B)
    toks = torch.from_numpy(np.random.default_rng(7).integers(2, 100, (B, T)))
    pos = _i32([0, 5])
    with torch.inference_mode():
        vg = model.forward_batch_spec_paged(a, toks, pos, table)
        mg = model.forward_batch_mixed_paged(b, toks, pos, _i32([T, T]),
                                             table)
    assert torch.equal(vg, mg)
    assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


def test_all_span_one_is_plain_decode():
    from distributed_llama_tpu_torch.runtime.paging import SCRAP_PAGE

    model = _model()
    spec, B, T = model.spec, 2, 3
    a, b = _pool(spec, B), _pool(spec, B)
    table = _table(spec, B)
    toks = torch.tensor([7, 9])
    pos = _i32([0, 6])
    win = torch.zeros((B, T), dtype=torch.int64)
    win[:, 0] = toks
    with torch.inference_mode():
        lg = model.forward_batch_paged(a, toks, pos, table)
        mg = model.forward_batch_mixed_paged(b, win, pos, _i32([1, 1]),
                                             table)
    tol = LOGIT_RTOL * lg.abs().max().item()
    np.testing.assert_allclose(mg[:, 0].numpy(), lg.numpy(), rtol=0,
                               atol=tol)
    live = [p for p in range(a.k.shape[1]) if p != SCRAP_PAGE]
    np.testing.assert_allclose(a.k[:, live].numpy(), b.k[:, live].numpy(),
                               rtol=0, atol=1e-5)
    assert b.k[:, SCRAP_PAGE].abs().sum() > 0  # the padding's dead writes


def test_span_edge_writes_go_to_the_scrap_page():
    from distributed_llama_tpu_torch.runtime.paging import SCRAP_PAGE

    model = _model()
    spec, B, T = model.spec, 2, 3
    a, b = _pool(spec, B), _pool(spec, B)
    table = _table(spec, B)
    toks = torch.from_numpy(np.random.default_rng(3).integers(2, 100, (B, T)))
    pos = _i32([0, 0])
    with torch.inference_mode():
        vg = model.forward_batch_spec_paged(a, toks, pos, table)
        mg = model.forward_batch_mixed_paged(b, toks, pos, _i32([1, T]),
                                             table)
    assert torch.equal(vg[0, :1], mg[0, :1]) and torch.equal(vg[1], mg[1])
    diff = {int(p) for _, p in
            torch.nonzero((a.k != b.k).any(-1).any(-1).any(-1))}
    # row 0's positions 1..2 live on its page 0: verify wrote them there,
    # mixed on the scrap page
    assert diff == {SCRAP_PAGE, int(table[0, 0])}
    assert torch.equal(a.k[:, table[1].long()], b.k[:, table[1].long()])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _separate(temperature):
    """The port's separate-dispatch engine (admission prefill at chunk 4)."""
    return _port(_reqs(), 24, temperature=temperature, prefill_chunk=4)[1]


@pytest.mark.parametrize("budget,temperature",
                         [(2, 0.0), (2, 0.9), (4, 0.0), (4, 0.9),
                          (8, 0.0), (8, 0.9), (16, 0.0), (16, 0.9)])
def test_streams_equal_separate_dispatch_and_jax(budget, temperature):
    (eng, got, st), (want, want_stats) = _both(
        _reqs(), 24, temperature=temperature, dispatch_tokens=budget)
    assert got == _separate(temperature) == want
    assert (st.tokens, st.steps, st.pauses, st.overrun_steps) == want_stats
    assert st.overrun_steps == 0 and st.prefill_chunks == 0
    assert all(s.free for s in eng._pool) and eng.audit_pages() == []


def test_q8_pages_equal_jax_and_separate_dispatch():
    (eng, got, st), (want, want_stats) = _both(
        _reqs(4), 16, slots=3, kv_pages=24, dispatch_tokens=6,
        kv_quant="q8")
    _, plain, _ = _port(_reqs(4), 16, slots=3, kv_pages=24, kv_quant="q8")
    assert got == want == plain
    assert (st.tokens, st.steps, st.pauses, st.overrun_steps) == want_stats
    assert eng.audit_pages() == []


def test_prefill_only_tail_with_zero_active_decodes():
    long_prompt = [[1] + [5 + (i % 20) for i in range(20)]]
    (_, got, st), (want, want_stats) = _both(long_prompt, 25,
                                             dispatch_tokens=8)
    _, sep, _ = _port(long_prompt, 25, prefill_chunk=4)
    assert got == sep == want
    assert (st.tokens, st.steps, st.pauses, st.overrun_steps) == want_stats
    # 20 forced positions in 3 budget-8 slices, then one token a dispatch
    assert st.steps >= 5 and st.tokens == 25


def test_auto_budget_and_floor():
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine

    host = _params()[1]
    spec = _port_spec(SPEC)
    eng = ContinuousEngine(spec, host, 4, 0.0, 0.9, 7, page_size=PS,
                           prefill_chunk=6, dispatch_tokens=-1, device="cpu")
    assert eng.dispatch_tokens == 4 - 1 + 6
    eng = ContinuousEngine(spec, host, 3, 0.0, 0.9, 7, page_size=PS,
                           dispatch_tokens=-1, device="cpu")
    assert eng.dispatch_tokens == 3 - 1 + 2
    with pytest.raises(ValueError, match="must be >= 2"):
        ContinuousEngine(spec, host, 3, 0.0, 0.9, 7, page_size=PS,
                         dispatch_tokens=1, device="cpu")
    (_, got, _), (want, _) = _both(_reqs(3), 16, slots=3, dispatch_tokens=2)
    assert got == want


@pytest.mark.parametrize("kw,match", [
    ({"dispatch_tokens": 8, "spec_k": 4, "page_size": PS},
     "incompatible with spec_k"),
    ({"dispatch_tokens": 8}, "requires the paged KV cache")])
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
