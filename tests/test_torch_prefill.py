"""Chunked prompt prefill in the port against the JAX package: the T > 1
forward (logits and cache rows), ``Engine.prefill`` (against the JAX
``Engine.prefill`` and against the port's own token-by-token fill), the
near-seq_len tail, the overflow error, and the ``generate`` prefill gates.

Both sides get the same numpy parameter tree (the JAX package's
``synth_params``, carried into the port by ``params_from_reference``).
Tolerances: atol 1e-4 + rtol 1e-4 on logits and 2e-5 on cache rows, as in
tests/test_torch_forward.py and tests/test_prefill.py — the frameworks, and
a T-token pass against T one-token passes, sum in different orders (f32
throughout), far below any layout or masking fault (O(0.1)).
"""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_llama_tpu.models.spec import TransformerSpec
from distributed_llama_tpu.models.synth import synth_params
from distributed_llama_tpu.ops.quants import FloatType

ATOL = RTOL = 1e-4
CACHE_TOL = 2e-5

SPECS = {
    "f32": TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=4, vocab_size=96, seq_len=40),
    "q40": TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=4, vocab_size=96, seq_len=40,
                           weights_float_type=FloatType.Q40),
    "gqa_q40": TransformerSpec(dim=128, hidden_dim=256, n_layers=2,
                               n_heads=8, n_kv_heads=2, vocab_size=64,
                               seq_len=40, weights_float_type=FloatType.Q40),
}
_FIELDS = ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads",
           "vocab_size", "seq_len", "weights_float_type", "buffer_float_type")


def _port_spec(spec):
    from distributed_llama_tpu_torch.models.spec import TransformerSpec as PS

    return PS(**{f: getattr(spec, f) for f in _FIELDS})


def _params(spec, seed=3):
    return synth_params(spec, q40=spec.weights_float_type == FloatType.Q40,
                        seed=seed)


def _host(params):
    """The JAX package's numpy tree with its Q40 leaves as the port's
    Q40Weight: the host tree the port's Engine takes."""
    from distributed_llama_tpu_torch.io.loader import Q40Weight

    return {k: (Q40Weight(np.asarray(v.qs), np.asarray(v.d16))
                if hasattr(v, "qs") else v) for k, v in params.items()}


@pytest.mark.parametrize("t_len", [4, 16])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_forward_chunk_matches_reference(name, t_len):
    """One token at pos 0, then a T-token chunk at pos 1: the chunk's
    (T, vocab) logits and the cache rows 0..T equal the JAX forward's."""
    import jax.numpy as jnp

    from distributed_llama_tpu.models.llama import (forward, init_cache,
                                                    params_to_device)
    from distributed_llama_tpu_torch.models import llama

    spec = SPECS[name]
    params = _params(spec)
    toks = [int(t) for t in np.random.default_rng(t_len).integers(
        2, spec.vocab_size, t_len)]
    dev = params_to_device(params)
    cache = init_cache(spec)
    _, cache = forward(spec, dev, cache, jnp.asarray([1], jnp.int32),
                       jnp.int32(0))
    want, cache = forward(spec, dev, cache, jnp.asarray(toks, jnp.int32),
                          jnp.int32(1))

    pspec = _port_spec(spec)
    model = llama.Llama(pspec, llama.params_from_reference(params, "cpu"))
    pc = llama.init_cache(pspec, "cpu")
    with torch.inference_mode():
        model(pc, 1, 0)
        got = model(pc, toks, 1)
    assert tuple(got.shape) == (t_len, spec.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    for mine, theirs in ((pc.k, cache.k), (pc.v, cache.v)):
        np.testing.assert_allclose(mine[:, :t_len + 1].numpy(),
                                   np.asarray(theirs)[:, :t_len + 1],
                                   atol=CACHE_TOL, rtol=CACHE_TOL)


def test_forward_without_logits_skips_the_head():
    """logits=False (the prefill call) returns None and fills the same
    cache rows as the full forward."""
    from distributed_llama_tpu_torch.models import llama

    spec = _port_spec(SPECS["q40"])
    params = llama.params_from_reference(_params(SPECS["q40"]), "cpu")
    model = llama.Llama(spec, params)
    a, b = llama.init_cache(spec, "cpu"), llama.init_cache(spec, "cpu")
    with torch.inference_mode():
        assert model(a, [1, 5, 9], 0, logits=False) is None
        assert model(b, [1, 5, 9], 0).shape == (3, spec.vocab_size)
    torch.testing.assert_close(a.k, b.k, rtol=0, atol=0)
    torch.testing.assert_close(a.v, b.v, rtol=0, atol=0)


def _engines(spec, params):
    from distributed_llama_tpu.runtime.generate import Engine as RefEngine
    from distributed_llama_tpu_torch.runtime.generate import Engine

    return (RefEngine(spec, params),
            Engine(_port_spec(spec), _host(params), "cpu"))


@pytest.mark.parametrize("chunk", [2, 4, 128])
def test_engine_prefill_matches_reference_and_stepwise(chunk):
    """Engine.prefill: the port's live cache rows and next-step logits equal
    the JAX Engine.prefill's and the port's own token-by-token fill."""
    from distributed_llama_tpu_torch.runtime.generate import Engine

    spec = SPECS["gqa_q40"]
    params = _params(spec, seed=9)
    tokens = [1, 9, 14, 23, 5, 40, 7]
    ref, port = _engines(spec, params)
    ref.prefill(tokens, 0, chunk=chunk)
    port.prefill(tokens, 0, chunk=chunk)
    want = ref.infer(33, len(tokens))
    got = port.infer(33, len(tokens))

    step = Engine(_port_spec(spec), _host(params), "cpu")
    for p, t in enumerate(tokens):
        step.infer(t, p)
    stepped = step.infer(33, len(tokens))

    n = len(tokens) + 1
    for other in (np.asarray(ref.cache.k)[:, :n], step.cache.k[:, :n].numpy()):
        np.testing.assert_allclose(port.cache.k[:, :n].numpy(), other,
                                   atol=CACHE_TOL, rtol=CACHE_TOL)
    np.testing.assert_allclose(port.cache.v[:, :n].numpy(),
                               np.asarray(ref.cache.v)[:, :n],
                               atol=CACHE_TOL, rtol=CACHE_TOL)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, stepped, atol=ATOL, rtol=RTOL)


def test_engine_prefill_near_seq_len_tail():
    """A padded window that would cross seq_len runs as T=1 steps instead
    of being clamped back over real positions (the JAX test_prefill tail
    case): 38 tokens at chunk 12 in a 40-slot cache, against stepwise."""
    from distributed_llama_tpu_torch.runtime.generate import Engine

    spec = SPECS["f32"]
    params = _params(spec, seed=4)
    tokens = [int(t) for t in np.random.default_rng(3).integers(
        3, spec.vocab_size, spec.seq_len - 2)]
    tokens[0] = 1
    calls = []
    port = Engine(_port_spec(spec), _host(params), "cpu")
    forward = port.model.forward

    def spy(cache, toks, pos, logits=True):
        calls.append((len(toks), pos))
        return forward(cache, toks, pos, logits)

    port.model.forward = spy
    port.prefill(tokens, 0, chunk=12)
    # 3 full windows, then 2 tokens whose padded window would reach 48
    assert calls == [(12, 0), (12, 12), (12, 24), (1, 36), (1, 37)]
    step = Engine(_port_spec(spec), _host(params), "cpu")
    for p, t in enumerate(tokens):
        step.infer(t, p)
    np.testing.assert_allclose(port.cache.k[:, :38].numpy(),
                               step.cache.k[:, :38].numpy(),
                               atol=CACHE_TOL, rtol=CACHE_TOL)


def test_engine_prefill_pads_a_partial_window():
    """A partial last window that fits runs as one padded T=chunk pass
    (its junk rows past the prompt are later overwritten by decode)."""
    from distributed_llama_tpu.runtime.generate import run_chunked_prefill \
        as ref_schedule
    from distributed_llama_tpu_torch.runtime.generate import \
        run_chunked_prefill

    for tokens, pos0, chunk, seq_len in (([5] * 11, 0, 4, 40),
                                         ([5] * 11, 30, 4, 40),
                                         ([5] * 3, 0, 128, 40)):
        mine, theirs = [], []
        run_chunked_prefill(lambda p, s: mine.append((list(p), s)), tokens,
                            pos0, chunk, seq_len)
        ref_schedule(lambda p, s: theirs.append((list(p), s)), tokens, pos0,
                     chunk, seq_len)
        assert mine == theirs


def test_engine_prefill_overflow_raises_before_writing():
    spec = SPECS["f32"]
    _, port = _engines(spec, _params(spec))
    with pytest.raises(ValueError, match="prefill overflow"):
        port.prefill([1] * 10, spec.seq_len - 5, chunk=4)
    assert not port.cache.k.any() and not port.cache.v.any()


class _IdTokenizer:
    def encode(self, text, bos=True, eos=False):
        return [1] + [3 + b for b in text.encode()]

    def decode_piece(self, prev, tok):
        return b"?"


class _MidBos(_IdTokenizer):
    def encode(self, text, bos=True, eos=False):
        return [1, 9, 1, 14, 23]  # BOS at index 2


GATES = {"applies": (_IdTokenizer, "abcde", 12),
         "prompt_reaches_steps": (_IdTokenizer, "abcdefghij", 6),
         "mid_stream_bos": (_MidBos, "x", 12)}


@pytest.mark.parametrize("case", sorted(GATES))
@pytest.mark.parametrize("temp", [0.0, 0.9])
def test_generate_prefill_gates_match_reference(case, temp):
    """generate(..., prefill_chunk=4) gives the JAX stream whether prefill
    applies or gates off (prompt >= steps, a BOS inside the prompt), and
    equals the port's stream without prefill."""
    from distributed_llama_tpu.runtime.generate import generate as ref_gen
    from distributed_llama_tpu.runtime.sampling import Sampler as RefSampler
    from distributed_llama_tpu_torch.runtime.generate import Engine, generate
    from distributed_llama_tpu_torch.runtime.sampling import Sampler

    spec = dataclasses.replace(SPECS["q40"], seq_len=16, vocab_size=300)
    params = _params(spec, seed=9)
    tok_cls, prompt, steps = GATES[case]
    ref, port = _engines(spec, params)
    want, _ = ref_gen(ref, tok_cls(), RefSampler(spec.vocab_size, temp, 0.9,
                                                 77, use_native=False),
                      prompt, steps, quiet=True, prefill_chunk=4)
    got, stats = generate(port, tok_cls(), Sampler(spec.vocab_size, temp,
                                                   0.9, 77),
                          prompt, steps, quiet=True, prefill_chunk=4)
    assert got == want
    fresh = Engine(_port_spec(spec), _host(params), "cpu")
    again, _ = generate(fresh, tok_cls(), Sampler(spec.vocab_size, temp, 0.9,
                                                  77), prompt, steps,
                        quiet=True)
    assert got == again
    if case == "applies":  # the prompt's 5 positions never ran the loop
        assert stats.tokens == steps - 5
