"""Port forward vs the JAX reference forward on tiny synthetic models.

Both sides get the same numpy parameter tree (models/synth.synth_params of
the JAX package, carried into the port by params_from_reference) and the
same token stream; each step's f32 logits must agree. Tolerance: the two
frameworks sum in different orders (XLA einsum vs torch matmul/softmax) and
their f32 pow/cos/sin may differ by an ulp, so logits agree to
atol 1e-4 + rtol 1e-4 at these widths (|logits| ~ 1), far below any
layout or value-map fault (O(0.1)).
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu.models.spec import TransformerSpec
from distributed_llama_tpu.models.synth import synth_params
from distributed_llama_tpu.ops.quants import FloatType

ATOL = RTOL = 1e-4

SPECS = {
    "f32": TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=4, vocab_size=96, seq_len=16),
    "q40": TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                           n_kv_heads=4, vocab_size=96, seq_len=16,
                           weights_float_type=FloatType.Q40),
    "gqa_q40": TransformerSpec(dim=128, hidden_dim=256, n_layers=2,
                               n_heads=8, n_kv_heads=2, vocab_size=64,
                               seq_len=16, weights_float_type=FloatType.Q40),
    "gqa_f32": TransformerSpec(dim=64, hidden_dim=96, n_layers=3, n_heads=4,
                               n_kv_heads=2, vocab_size=64, seq_len=16),
}


def _jax_steps(spec, params, tokens):
    import jax.numpy as jnp

    from distributed_llama_tpu.models.llama import (forward, init_cache,
                                                    params_to_device)

    dev = params_to_device(params)
    cache = init_cache(spec)
    out = []
    for pos, tok in enumerate(tokens):
        logits, cache = forward(spec, dev, cache,
                                jnp.asarray([tok], jnp.int32), jnp.int32(pos))
        out.append(np.asarray(logits[0]))
    return out


def _port_steps(spec, params, tokens):
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.models.spec import \
        TransformerSpec as PortSpec

    pspec = PortSpec(**{f: getattr(spec, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads",
        "vocab_size", "seq_len")})
    dev = llama.params_from_reference(params, "cpu")
    model = llama.Llama(pspec, dev)
    cache = llama.init_cache(pspec, "cpu")
    out = []
    with torch.inference_mode():
        for pos, tok in enumerate(tokens):
            out.append(model(cache, tok, pos)[0].numpy())
    return out


@pytest.mark.parametrize("name", sorted(SPECS))
def test_forward_logits_match_reference(name):
    spec = SPECS[name]
    params = synth_params(spec, q40=spec.weights_float_type == FloatType.Q40,
                          seed=3)
    tokens = [1, 7, 33, 5, 12, 9]
    want = _jax_steps(spec, params, tokens)
    got = _port_steps(spec, params, tokens)
    for pos, (w, g) in enumerate(zip(want, got)):
        assert g.shape == w.shape == (spec.vocab_size,)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name} pos {pos}")


def test_fused_q40_matches_unfused():
    """wqkv/w13 row concatenation changes no output row: the fused port
    forward equals one over the unfused weights (plain Q40 per matrix)."""
    from distributed_llama_tpu_torch.io.loader import Q40Weight
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.models.synth import \
        synth_params as port_synth
    from distributed_llama_tpu_torch.models.spec import TransformerSpec as PS
    from distributed_llama_tpu_torch.ops.linear import q40_to_device

    spec = PS(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=64, seq_len=8)
    host = port_synth(spec, q40=True, seed=2)
    fused = llama.params_to_device(host, "cpu")
    assert "wqkv" in fused and "w13" in fused and "wq" not in fused
    unfused = {k: (q40_to_device(v, "cpu") if isinstance(v, Q40Weight)
                   else torch.from_numpy(v)) for k, v in host.items()}
    c1, c2 = llama.init_cache(spec, "cpu"), llama.init_cache(spec, "cpu")
    m1, m2 = llama.Llama(spec, fused), llama.Llama(spec, unfused)
    for pos, tok in enumerate([1, 4]):
        a = m1(c1, tok, pos)
        b = m2(c2, tok, pos)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,head_size", [(64, 16), (96, 32), (256, 128)])
def test_rope_rotate_matches_reference(n, head_size):
    """Interleaved-pair RoPE, head_dim = (2p) mod hs over the whole vector,
    as the forward applies it: per-step tables (rope_tables) and _rotate,
    against the reference's rope_rotate (f32 pow/cos/sin: atol 1e-5 at
    positions up to 2047)."""
    import jax.numpy as jnp

    from distributed_llama_tpu.models.llama import rope_rotate as jax_rope
    from distributed_llama_tpu_torch.models.llama import (_rotate, rope_freq,
                                                          rope_tables)

    rng = np.random.default_rng(n)
    x = rng.standard_normal((4, n)).astype(np.float32)
    positions = np.array([0, 1, 37, 2047], np.int32)
    want = np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(positions),
                               head_size))
    freq = rope_freq(n, head_size, "cpu")
    xt = torch.from_numpy(x)
    got = torch.cat([_rotate(xt[i:i + 1], *rope_tables(freq, int(p)))
                     for i, p in enumerate(positions)]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got[0], x[0])  # position 0 is identity


def test_forward_rejects_position_outside_cache():
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.models.synth import \
        synth_params as port_synth
    from distributed_llama_tpu_torch.models.spec import TransformerSpec as PS

    spec = PS(dim=64, hidden_dim=96, n_layers=1, n_heads=4, n_kv_heads=4,
              vocab_size=32, seq_len=4)
    model = llama.Llama(spec, llama.params_to_device(port_synth(spec,
                                                                q40=False),
                                                     "cpu"))
    with pytest.raises(ValueError, match="outside the cache"):
        model(llama.init_cache(spec, "cpu"), 1, 4)


@pytest.mark.parametrize("name", ["f32", "gqa_q40"])
def test_init_cache_matches_reference_layout(name):
    """The KV cache keeps the reference's (L, S, n_kv, hs) f32 layout, zeroed,
    whatever the weights' type."""
    from distributed_llama_tpu.models.llama import init_cache as jax_init
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.models.spec import \
        TransformerSpec as PortSpec

    spec = SPECS[name]
    want = jax_init(spec)
    got = llama.init_cache(PortSpec(**{f: getattr(spec, f) for f in (
        "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads",
        "vocab_size", "seq_len", "weights_float_type")}), "cpu")
    for g, w in ((got.k, want.k), (got.v, want.v)):
        assert tuple(g.shape) == tuple(w.shape)
        assert g.dtype == torch.float32 and str(w.dtype) == "float32"
        assert not g.any()
