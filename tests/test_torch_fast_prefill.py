"""``--fast-prefill`` and ``--kv-cache-dtype bf16`` in the port against the
JAX package, on the CPU (the kernels' plain versions):

* the bf16 Q40 GEMM (K3b's plain version) against every arm of the JAX
  package that computes it: the Pallas ``_kernel`` bf16 body
  (DLLAMA_PREFILL_MATMUL=legacy), the scratch body (=scratch), both in
  interpret mode, and the dequantize-then-dot arm (=auto under bf16);
* bf16 prefill attention (K4b's plain version) against the JAX Pallas
  ``prefill_attention(bf16=True)`` in interpret mode, on f32 and bf16
  caches; decode and f32-dot prefill attention over a bf16 cache against
  the JAX kernels;
* ``Engine(fast_prefill=True)`` and ``Engine(cache_dtype=bf16)`` against
  the JAX ``Engine`` with the same options, the fast-vs-parity drift
  against the JAX package's own bound, and the isolation of the bf16 route
  to T > 8 windows.

Tolerances. Both sides of every bf16 comparison form the same exact f32
products of the same bf16 values and differ only in the order of their f32
sums, so the Q40 and attention comparisons hold at the f32 tolerances of
tests/test_torch_q40.py and tests/test_torch_attention.py. At these shapes
the JAX bf16 attention paths walk the whole live prefix in one block (its
CPU path: one block of the largest divisor of seq_len up to 512; its
Pallas body: the same block size), so p is rounded to bf16 against the
same row max as in the plain version; over longer prefixes the JAX package
rounds p against each walked block's running max instead. Through whole
layers a last-place difference of an f32 sum can round an activation to the
neighbouring bf16 value (2^-8 relative) on one side only, so the engine
comparisons allow more: FAST_TOL on cache rows and logits.
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu.io.loader import Q40Weight as RefQ40
from distributed_llama_tpu.models.spec import TransformerSpec
from distributed_llama_tpu.models.synth import synth_params
from distributed_llama_tpu.ops.quants import FloatType, quantize_q40

# rtol/atol of the Q40 and attention plain versions against the JAX
# package: the f32 tolerances of test_torch_q40.py / test_torch_attention.py
Q40_RTOL, Q40_ATOL = 1e-5, 1e-4
ATT_TOL = 1e-5
# cache rows and logits of the fast engines against each other, relative to
# the largest magnitude: an occasional one-sided bf16 rounding of an
# activation (2^-8 relative) moves an output by a fraction of that
FAST_TOL = 2e-3


def _q40(d, n, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d, n)) * 0.3).astype(np.float32)
    return RefQ40(*quantize_q40(w))


def _port_q40(w):
    from distributed_llama_tpu_torch.io.loader import Q40Weight

    return Q40Weight(torch.from_numpy(w.qs), torch.from_numpy(w.d16))


# (d, n): rows off every 64/128 tile, odd block counts (5 and 3)
GEMM_SHAPES = [(136, 160), (200, 96)]


@pytest.mark.parametrize("t", [9, 16, 24])
@pytest.mark.parametrize("d,n", GEMM_SHAPES)
@pytest.mark.parametrize("arm", ["legacy", "scratch", "auto"])
def test_plain_bf16_gemm_matches_jax_arms(monkeypatch, arm, d, n, t):
    """q40_matmul(bf16=True) on CPU tensors (q40_matmul_bf16_plain) against
    the JAX ``q40_matmul`` under ``matmul_precision("bf16")``: the arm is
    chosen by DLLAMA_PREFILL_MATMUL, and the test checks that the Pallas
    arms ran a Pallas body and ``auto`` the dequantize-then-dot arm."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops import pallas_q40
    from distributed_llama_tpu.ops.linear import matmul_precision
    from distributed_llama_tpu_torch.ops import q40

    monkeypatch.setenv("DLLAMA_PREFILL_MATMUL", arm)
    dequant_calls = []
    real = pallas_q40._dequant_matmul

    def spy(*args):
        dequant_calls.append(args)
        return real(*args)

    monkeypatch.setattr(pallas_q40, "_dequant_matmul", spy)
    w = _q40(d, n, seed=d + t)
    x = np.random.default_rng(t).standard_normal((t, n)).astype(np.float32)
    with matmul_precision("bf16"):
        want = np.asarray(pallas_q40.q40_matmul(w, jnp.asarray(x),
                                                interpret=True))
    assert bool(dequant_calls) == (arm == "auto")
    counts = [k.launches for k in q40.KERNELS]
    got = q40.q40_matmul(_port_q40(w), torch.from_numpy(x), bf16=True)
    assert [k.launches for k in q40.KERNELS] == counts
    assert tuple(got.shape) == want.shape == (t, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=Q40_RTOL,
                               atol=Q40_ATOL)
    # the bf16 rounding is real: the f32 product differs by far more
    f32 = q40.q40_matmul(_port_q40(w), torch.from_numpy(x)).numpy()
    assert np.abs(f32 - want).max() > 100 * Q40_ATOL


@pytest.mark.parametrize("t", [1, 4, 8])
def test_bf16_route_at_small_t_is_parity_bitwise(t):
    """At T <= 8 the bf16 flag changes nothing (the JAX package's T=1 and
    small-T bodies ignore it): the kernel wrapper and the fast route's
    plain version both equal the parity result bit for bit."""
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.ops import q40

    w = _port_q40(_q40(72, 160, seed=t))
    x = torch.from_numpy(np.random.default_rng(t).standard_normal(
        (t, 160)).astype(np.float32))
    want = q40.q40_matmul(w, x)
    for got in (q40.q40_matmul(w, x, bf16=True),
                llama.FAST.q40(w, x), llama.FAST_PLAIN.q40(w, x)):
        assert torch.equal(got, want)


def test_dense_bf16_matmul_matches_jax_einsum():
    """The fast route's dense product (F32 weights) against the JAX
    package's bf16 einsum with f32 output."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.linear import matmul, matmul_precision
    from distributed_llama_tpu_torch.ops.linear import (dense_matmul,
                                                        dense_matmul_bf16)

    rng = np.random.default_rng(0)
    w = rng.standard_normal((96, 80)).astype(np.float32)
    x = rng.standard_normal((12, 80)).astype(np.float32)
    with matmul_precision("bf16"):
        want = np.asarray(matmul(jnp.asarray(w), jnp.asarray(x)))
    got = dense_matmul_bf16(torch.from_numpy(w), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=Q40_RTOL,
                               atol=Q40_ATOL)
    f32 = dense_matmul(torch.from_numpy(w), torch.from_numpy(x)).numpy()
    assert np.abs(f32 - want).max() > 100 * Q40_ATOL


# the shape of tests/test_pallas_attention.py's bf16 prefill case
S, N_KV, HS, T_LEN, POS = 64, 2, 128, 16, 24


def _attention_inputs(kv_mul, cache, seed, t_len=T_LEN):
    rng = np.random.default_rng(seed)
    k_all, v_all = (rng.normal(size=(2, S, N_KV, HS)).astype(np.float32)
                    for _ in range(2))
    q = rng.normal(size=(t_len, N_KV * kv_mul, HS)).astype(np.float32)
    if cache == "bf16":  # the values a bf16 cache holds, as f32
        k_all, v_all = (torch.from_numpy(a).to(torch.bfloat16).float()
                        .numpy() for a in (k_all, v_all))
    return q, k_all, v_all


def _caches(k_all, v_all, cache):
    """The same values as the port's cache tensors and as JAX arrays."""
    import jax.numpy as jnp

    dt = torch.bfloat16 if cache == "bf16" else torch.float32
    jdt = jnp.bfloat16 if cache == "bf16" else jnp.float32
    return ((torch.from_numpy(k_all).to(dt), torch.from_numpy(v_all).to(dt)),
            (jnp.asarray(k_all).astype(jdt), jnp.asarray(v_all).astype(jdt)))


@pytest.mark.parametrize("kv_mul", [1, 2])
@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_plain_bf16_prefill_attention_matches_pallas(kv_mul, cache):
    """prefill_attention(bf16=True) on CPU tensors
    (prefill_attention_bf16_plain) against the JAX Pallas
    ``prefill_attention(bf16=True)`` in interpret mode."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_attention import \
        prefill_attention as ref
    from distributed_llama_tpu_torch.ops import attention

    q, k_all, v_all = _attention_inputs(kv_mul, cache, seed=kv_mul)
    (kt, vt), (kj, vj) = _caches(k_all, v_all, cache)
    layer = 1
    want = np.asarray(ref(jnp.asarray(q), kj[layer], vj[layer], POS,
                          kv_mul=kv_mul, bf16=True, interpret=True))
    counts = [k.launches for k in attention.KERNELS]
    got = attention.prefill_attention(torch.from_numpy(q), kt, vt, layer,
                                      POS, kv_mul, bf16=True)
    assert [k.launches for k in attention.KERNELS] == counts
    np.testing.assert_allclose(got.numpy(), want.reshape(T_LEN, -1),
                               rtol=ATT_TOL, atol=ATT_TOL)
    f32 = attention.prefill_attention(torch.from_numpy(q), kt, vt, layer,
                                      POS, kv_mul).numpy()
    assert np.abs(f32 - want.reshape(T_LEN, -1)).max() > 10 * ATT_TOL


@pytest.mark.parametrize("kv_mul", [1, 2])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_plain_attention_over_bf16_cache_matches_pallas(kv_mul, kind):
    """decode_attention / prefill_attention (f32 dots) over a bf16 cache
    against the JAX Pallas kernels in interpret mode on the same bf16
    cache: the cache widens exactly, so the f32 tolerance holds."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops import pallas_attention as ref
    from distributed_llama_tpu_torch.ops import attention

    q, k_all, v_all = _attention_inputs(kv_mul, "bf16", seed=5 + kv_mul)
    (kt, vt), (kj, vj) = _caches(k_all, v_all, "bf16")
    layer = 1
    if kind == "decode":
        want = ref.decode_attention(jnp.asarray(q[0]), kj, vj, layer, POS,
                                    kv_mul=kv_mul, interpret=True)
        got = attention.decode_attention(torch.from_numpy(q[0]), kt, vt,
                                         layer, POS, kv_mul)
    else:
        want = ref.prefill_attention(jnp.asarray(q), kj[layer], vj[layer],
                                     POS, kv_mul=kv_mul, interpret=True)
        got = attention.prefill_attention(torch.from_numpy(q), kt, vt, layer,
                                          POS, kv_mul)
    want = np.asarray(want).reshape(got.shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATT_TOL,
                               atol=ATT_TOL)


def test_prefill_bf16_plain_rounds_p_and_not_l():
    """K4b's plain version: l sums the unrounded p and only the p.v product
    takes bf16(p). With every value 1, out = sum bf16(p) / sum p, which is
    not 1 when p is not a bf16 value (it would be 1 if l summed bf16(p))."""
    from distributed_llama_tpu_torch.ops.attention import (
        attention_scale, prefill_attention_bf16_plain)

    g = torch.Generator().manual_seed(0)
    k_all = torch.randn((1, 8, 1, 16), generator=g)
    v_all = torch.ones((1, 8, 1, 16))
    q = torch.randn((3, 1, 16), generator=g)
    out = prefill_attention_bf16_plain(q, k_all, v_all, 0, 2, 1)
    for i in range(3):  # row i sees keys 0..2+i
        qb = q[i, 0].bfloat16().float()
        kb = k_all[0, :3 + i, 0].bfloat16().float()
        s = (kb @ qb) * attention_scale(16)
        p = torch.exp(s - s.max())
        want = p.bfloat16().float().sum() / p.sum()
        torch.testing.assert_close(out[i], want.expand(16), rtol=1e-6,
                                   atol=1e-6)
        assert want != 1.0


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

SPECS = {  # seq_len 64: the JAX bf16 walk takes the live prefix in one block
    "f32": TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=4, vocab_size=96, seq_len=64),
    "q40": TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=4, vocab_size=96, seq_len=64,
                           weights_float_type=FloatType.Q40),
    "gqa_q40": TransformerSpec(dim=128, hidden_dim=256, n_layers=2,
                               n_heads=8, n_kv_heads=2, vocab_size=64,
                               seq_len=64, weights_float_type=FloatType.Q40),
}
_FIELDS = ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads",
           "vocab_size", "seq_len", "weights_float_type", "buffer_float_type")


def _port_spec(spec):
    from distributed_llama_tpu_torch.models.spec import TransformerSpec as PS

    return PS(**{f: getattr(spec, f) for f in _FIELDS})


def _params(spec, seed):
    return synth_params(spec, q40=spec.weights_float_type == FloatType.Q40,
                        seed=seed, scale=0.3)


def _host(params):
    from distributed_llama_tpu_torch.io.loader import Q40Weight

    return {k: (Q40Weight(np.asarray(v.qs), np.asarray(v.d16))
                if hasattr(v, "qs") else v) for k, v in params.items()}


def _port_engine(spec, params, **kw):
    from distributed_llama_tpu_torch.runtime.generate import Engine

    return Engine(_port_spec(spec), _host(params), "cpu", **kw)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _tokens(spec, n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(
        2, spec.vocab_size, n)]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_fast_engine_prefill_matches_reference(name):
    """Engine(fast_prefill=True).prefill at chunk 12 (two full windows and
    a padded one, all through the bf16 route) against the JAX
    Engine(fast_prefill=True): cache rows and the next decode logits. Then
    the cache drift of fast against parity, in the JAX package's own bound
    (tests/test_prefill.py: 0 < drift < 2.5e-2 of the cache scale)."""
    from distributed_llama_tpu.runtime.generate import Engine as RefEngine

    spec = SPECS[name]
    params = _params(spec, seed=3)
    tokens = _tokens(spec, 30, seed=1)
    ref = RefEngine(spec, params, fast_prefill=True)
    fast = _port_engine(spec, params, fast_prefill=True)
    parity = _port_engine(spec, params)
    ref.prefill(tokens, 0, chunk=12)
    fast.prefill(tokens, 0, chunk=12)
    parity.prefill(tokens, 0, chunk=12)
    n = len(tokens)
    for mine, theirs in ((fast.cache.k, ref.cache.k),
                         (fast.cache.v, ref.cache.v)):
        assert _rel(mine[:, :n].numpy(), np.asarray(theirs)[:, :n]) \
            <= FAST_TOL
    want = ref.infer(7, n)
    got = fast.infer(7, n)
    assert _rel(got, want) <= FAST_TOL
    drift = _rel(fast.cache.k[:, :n].numpy(), parity.cache.k[:, :n].numpy())
    assert 0 < drift < 2.5e-2


def test_fast_prefill_drift_within_reference_bound():
    """The JAX package's own drift gate
    (tests/test_prefill.py::test_fast_prefill_bf16_tolerance_and_isolation)
    on its configuration, for the port: 12 tokens at chunk 12 fill the
    cache within 0 < drift < 2.5e-2 of the parity engine's, relative to
    its scale, and the next decode logits within 2.5e-2."""
    spec = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=300, seq_len=16)
    params = synth_params(spec, q40=False, seed=3, scale=0.3)
    tokens = [int(t) for t in np.random.default_rng(1).integers(
        2, spec.vocab_size, 12)]
    parity = _port_engine(spec, params)
    fast = _port_engine(spec, params, fast_prefill=True)
    parity.prefill(tokens, 0, chunk=12)
    fast.prefill(tokens, 0, chunk=12)
    drift = _rel(fast.cache.k[:, :12].numpy(),
                 parity.cache.k[:, :12].numpy())
    assert 0 < drift < 2.5e-2
    tok = tokens[-1] % spec.vocab_size
    assert _rel(fast.infer(tok, 12), parity.infer(tok, 12)) < 2.5e-2


def test_fast_route_only_above_eight_tokens():
    """The bf16 route takes the T > 8 windows only: at chunk 8 the fast
    engine's cache equals the parity engine's bit for bit, and so does a
    prefill that runs entirely as the T=1 tail (its padded window would
    cross seq_len); at chunk 12 every window (the padded last one too)
    takes FAST."""
    from distributed_llama_tpu_torch.models import llama

    spec = SPECS["gqa_q40"]
    params = _params(spec, seed=4)
    tokens = _tokens(spec, 20, seed=2)
    for chunk, pos0, toks in ((8, 0, tokens), (12, spec.seq_len - 6,
                                                tokens[:5])):
        fast = _port_engine(spec, params, fast_prefill=True)
        parity = _port_engine(spec, params)
        fast.prefill(toks, pos0, chunk)
        parity.prefill(toks, pos0, chunk)
        assert torch.equal(fast.cache.k, parity.cache.k)
        assert torch.equal(fast.cache.v, parity.cache.v)

    fast = _port_engine(spec, params, fast_prefill=True)
    routes = []
    forward = fast.model.forward

    def spy(cache, toks, pos, logits=True, route=None):
        n = 1 if isinstance(toks, int) else len(toks)
        routes.append((n, route is llama.FAST))
        return forward(cache, toks, pos, logits, route)

    fast.model.forward = spy
    fast.prefill(tokens, 0, 12)
    assert routes == [(12, True), (12, True)]
    fast.infer(3, 20)
    assert routes[-1] == (1, False)


def test_bf16_cache_engine_matches_reference():
    """Engine(cache_dtype=bfloat16): the cache holds bf16 and the decode
    logits over 6 steps follow the JAX Engine(cache_dtype=bfloat16); they
    stay within bf16 drift of the f32 engine's (tests/test_model.py allows
    0.05 on its O(1) logits; these reach ~10, so the bound is the relative
    2.5e-2 of the fast-prefill drift gate)."""
    import jax.numpy as jnp

    from distributed_llama_tpu.runtime.generate import Engine as RefEngine

    spec = SPECS["gqa_q40"]
    params = _params(spec, seed=5)
    ref = RefEngine(spec, params, cache_dtype=jnp.bfloat16)
    port = _port_engine(spec, params, cache_dtype=torch.bfloat16)
    f32 = _port_engine(spec, params)
    assert port.cache.k.dtype == port.cache.v.dtype == torch.bfloat16
    for pos, t in enumerate([1, 9, 30, 2, 17, 5]):
        want = ref.infer(t, pos)
        got = port.infer(t, pos)
        assert _rel(got, want) <= FAST_TOL, pos
        assert _rel(got, f32.infer(t, pos)) < 2.5e-2
    assert np.asarray(ref.cache.k).dtype == jnp.bfloat16
    assert _rel(port.cache.k[:, :6].float().numpy(),
                np.asarray(ref.cache.k[:, :6]).astype(np.float32)) \
        <= FAST_TOL
    port.reset()
    assert port.cache.k.dtype == torch.bfloat16 and not port.cache.k.any()


def test_fast_prefill_with_bf16_cache_matches_reference():
    """Both options together, against the JAX engine with both."""
    import jax.numpy as jnp

    from distributed_llama_tpu.runtime.generate import Engine as RefEngine

    spec = SPECS["gqa_q40"]
    params = _params(spec, seed=6)
    tokens = _tokens(spec, 26, seed=3)
    ref = RefEngine(spec, params, cache_dtype=jnp.bfloat16,
                    fast_prefill=True)
    port = _port_engine(spec, params, cache_dtype=torch.bfloat16,
                        fast_prefill=True)
    ref.prefill(tokens, 0, chunk=12)
    port.prefill(tokens, 0, chunk=12)
    n = len(tokens)
    assert _rel(port.cache.k[:, :n].float().numpy(),
                np.asarray(ref.cache.k[:, :n]).astype(np.float32)) \
        <= FAST_TOL
    assert _rel(port.infer(7, n), ref.infer(7, n)) <= FAST_TOL
