"""The port's fused T=1 decode step (``DLLAMA_LAYER_FUSION=headtail|on``:
Llama.forward_fused behind Llama.forward and the engine's loops) against
the JAX package's ``forward`` under the same mode.

Both sides get the same numpy weights (the JAX package's synth_params, d-
major kernel stacks on the JAX side with DLLAMA_Q40_KERNEL=pallas, the
Pallas kernels in interpret mode, as tests/test_pallas_layer.py runs them;
the codec layout and the kernels' plain versions on the port's CPU side).
Each JAX chain runs once per module (jit, one program per mode) and is
shared by the tests. Tolerance: the JAX test's own, logits atol 5e-4 +
rtol 1e-4, cache k/v atol 1e-4; tokens exactly.
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu.models.spec import TransformerSpec
from distributed_llama_tpu.ops.quants import FloatType

ATOL, RTOL = 5e-4, 1e-4
CACHE_ATOL = 1e-4
STEPS = 3

SPECS = {
    # GQA at head size 16: 'on' takes head/tail here, as in JAX
    "spec": TransformerSpec(dim=64, hidden_dim=96, n_layers=2, n_heads=4,
                            n_kv_heads=2, vocab_size=128, seq_len=32,
                            weights_float_type=FloatType.Q40),
    "mega_mha": TransformerSpec(dim=256, hidden_dim=96, n_layers=2,
                                n_heads=2, n_kv_heads=2, vocab_size=64,
                                seq_len=16, weights_float_type=FloatType.Q40),
    "mega_gqa": TransformerSpec(dim=512, hidden_dim=160, n_layers=2,
                                n_heads=4, n_kv_heads=2, vocab_size=64,
                                seq_len=16, weights_float_type=FloatType.Q40),
}
CHAINS = [("spec", "headtail"), ("spec", "on"), ("mega_mha", "headtail"),
          ("mega_gqa", "on")]
PROMPT = [3, 7, 11]


def _port_spec(spec, **kw):
    from distributed_llama_tpu_torch.models.spec import \
        TransformerSpec as PortSpec

    fields = ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads",
              "vocab_size", "seq_len", "weights_float_type",
              "buffer_float_type")
    return PortSpec(**{**{f: getattr(spec, f) for f in fields}, **kw})


def _host(name):
    from distributed_llama_tpu.models.synth import synth_params

    return synth_params(SPECS[name], q40=True, seed=11, scale=0.2)


def _port_host(name):
    """_host(name) as the port's host tree (its Q40Weight)."""
    from distributed_llama_tpu_torch.io.loader import Q40Weight

    return {k: (Q40Weight(np.asarray(v.qs), np.asarray(v.d16))
                if hasattr(v, "d16") else np.asarray(v))
            for k, v in _host(name).items()}


def _jax_params(spec, host):
    """The JAX package's fused-path tree: d-major kernel stacks with wqkv
    and w13, and wo_mega where the mode (read from the environment) and
    the shapes take the megakernel."""
    import jax
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.linear import (fuse_q40_layer_matmuls,
                                                  pack_q40_params)
    from distributed_llama_tpu.ops.pallas_layer import prepare_mega_params

    packed = fuse_q40_layer_matmuls(
        pack_q40_params(host, enable=True, allow_nb_major=False))
    return jax.tree_util.tree_map(jnp.asarray,
                                  prepare_mega_params(spec, packed))


@pytest.fixture(scope="module")
def jax_runs():
    """(name, mode) -> (greedy chain logits (STEPS, vocab), tokens, final
    cache k, v) from token 3 at pos 0; ('prefill', name) -> the logits of
    token 5 at pos 3 after PROMPT prefilled, under 'on'."""
    import os

    import jax
    import jax.numpy as jnp

    from distributed_llama_tpu.models.llama import forward, init_cache

    saved = {k: os.environ.get(k)
             for k in ("DLLAMA_LAYER_FUSION", "DLLAMA_Q40_KERNEL")}
    os.environ["DLLAMA_Q40_KERNEL"] = "pallas"
    out = {}
    try:
        for name, mode in CHAINS:
            os.environ["DLLAMA_LAYER_FUSION"] = mode
            spec = SPECS[name]
            params = _jax_params(spec, _host(name))
            # a fresh jit per mode: the mode is read while tracing
            step = jax.jit(lambda p, c, t, q: forward(spec, p, c, t, q))
            cache = init_cache(spec)
            tok = jnp.asarray([3], jnp.int32)
            logits_all, toks = [], []
            for pos in range(STEPS):
                logits, cache = step(params, cache, tok, jnp.int32(pos))
                logits_all.append(np.asarray(logits[0]))
                tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                toks.append(int(tok[0]))
            out[name, mode] = (np.stack(logits_all), toks,
                               np.asarray(cache.k), np.asarray(cache.v))
            if (name, mode) == ("spec", "on"):
                cache = init_cache(spec)
                _, cache = forward(spec, params, cache,
                                   jnp.asarray(PROMPT, jnp.int32),
                                   jnp.int32(0))
                logits, _ = step(params, cache, jnp.asarray([5], jnp.int32),
                                 jnp.int32(3))
                out["prefill", name] = np.asarray(logits[0])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def _port_model(name, mode):
    from distributed_llama_tpu_torch.models import llama

    spec = _port_spec(SPECS[name])
    model = llama.Llama(spec, llama.params_from_reference(_host(name), "cpu"),
                        fusion=mode)
    return spec, model


@pytest.mark.parametrize("name,mode", CHAINS)
def test_fused_chain_matches_jax(jax_runs, name, mode):
    """A STEPS-step greedy chain of Llama.forward under the mode: tokens,
    per-step logits and the final cache equal JAX's forward under it."""
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.ops.layer import mega_supported

    want, want_toks, want_k, want_v = jax_runs[name, mode]
    spec, model = _port_model(name, mode)
    assert model.fusion == mode
    assert mega_supported(spec) == name.startswith("mega")
    cache = llama.init_cache(spec, "cpu")
    tok, got, toks = 3, [], []
    with torch.inference_mode():
        for pos in range(STEPS):
            logits = model(cache, tok, pos)
            got.append(logits[0].numpy())
            tok = int(logits.argmax())
            toks.append(tok)
    assert toks == want_toks
    np.testing.assert_allclose(np.stack(got), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(cache.k.numpy(), want_k, atol=CACHE_ATOL)
    np.testing.assert_allclose(cache.v.numpy(), want_v, atol=CACHE_ATOL)


def test_fused_after_prefill_matches_jax(jax_runs):
    """Prefill (T > 1, unfused) then a fused step under 'on': JAX's
    test_fused_after_prefill on the port."""
    from distributed_llama_tpu_torch.models import llama

    spec, model = _port_model("spec", "on")
    cache = llama.init_cache(spec, "cpu")
    with torch.inference_mode():
        assert model(cache, PROMPT, 0, logits=False) is None
        got = model(cache, 5, 3)[0].numpy()
    np.testing.assert_allclose(got, jax_runs["prefill", "spec"], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("name,mode", CHAINS)
def test_forward_fused_with_device_position_equals_host_position(name,
                                                                  mode):
    """forward_fused at a device position (K5 at B = 1 for the attention,
    the cache written by index) equals the same step at a host position
    (K2, a sliced write), bit for bit on the plain versions."""
    from distributed_llama_tpu_torch.models import llama

    spec, model = _port_model(name, mode)
    c1, c2 = llama.init_cache(spec, "cpu"), llama.init_cache(spec, "cpu")
    with torch.inference_mode():
        for pos, tok in enumerate([3, 9, 1]):
            a = model(c1, tok, pos)
            b = model.forward_fused(c2, torch.tensor([tok]),
                                    torch.tensor([pos], dtype=torch.int32),
                                    mode)
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(c1.k, c2.k, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["headtail", "on"])
def test_engine_loops_give_the_host_stream_under_fusion(monkeypatch, mode):
    """The engine reads DLLAMA_LAYER_FUSION once; generate (the host loop,
    token by token and after a T = 3 chunked prefill) and generate_fast
    (the on-device loop at B = 1 through forward_fused) give one greedy
    stream, and the unfused engine gives it too."""
    from distributed_llama_tpu_torch.models.spec import \
        TransformerSpec as PortSpec
    from distributed_llama_tpu_torch.runtime.generate import (Engine,
                                                              generate,
                                                              generate_fast)
    from distributed_llama_tpu_torch.runtime.sampling import Sampler

    class Tok:  # ids as pieces: "a b c" -> [1, a, b, c]
        def encode(self, text, bos=True, eos=False):
            return [1, *map(int, text.split())]

        def decode_piece(self, prev, tok):
            return b"."

    name = "mega_gqa" if mode == "on" else "spec"
    host = _port_host(name)
    spec = _port_spec(SPECS[name])
    streams = {}
    for fusion in (mode, "off"):
        monkeypatch.setenv("DLLAMA_LAYER_FUSION", fusion)
        engine = Engine(spec, host, "cpu")
        assert engine.model.fusion == (None if fusion == "off" else mode)
        for label, fn, chunk in (("host", generate, 0),
                                 ("chunked", generate, 3),
                                 ("fast", generate_fast, 0)):
            engine.reset()
            streams[fusion, label] = fn(
                engine, Tok(), Sampler(spec.vocab_size, 0.0, 0.9, 1),
                "5 9 2 7 4", 12, quiet=True, prefill_chunk=chunk)[0]
    want = streams["off", "host"]
    assert len(want) >= 8
    assert all(s == want for s in streams.values()), streams


def test_q80_buffers_and_unknown_mode_behave_as_jax(monkeypatch):
    """q80 buffers keep the unfused path (the JAX supports() is False; the
    port's model takes no fused mode and its logits are the unfused ones);
    an unknown DLLAMA_LAYER_FUSION raises JAX's ValueError."""
    from distributed_llama_tpu.ops import pallas_layer
    from distributed_llama_tpu_torch.models import llama
    from distributed_llama_tpu_torch.runtime.generate import Engine

    monkeypatch.setenv("DLLAMA_Q40_KERNEL", "pallas")
    host = _host("spec")
    spec80 = TransformerSpec(**{**SPECS["spec"].__dict__,
                                "buffer_float_type": FloatType.Q80})
    assert not pallas_layer.supports(spec80, _jax_params(spec80, host))
    port80 = _port_spec(spec80)
    dev = llama.params_from_reference(host, "cpu")
    fused = llama.Llama(port80, dev, fusion="headtail")
    plain = llama.Llama(port80, dev)
    assert fused.fusion is None
    c1, c2 = llama.init_cache(port80, "cpu"), llama.init_cache(port80, "cpu")
    with torch.inference_mode():
        for pos, tok in enumerate([3, 9]):
            torch.testing.assert_close(fused(c1, tok, pos), plain(c2, tok, pos),
                                       rtol=0, atol=0)
    monkeypatch.setenv("DLLAMA_LAYER_FUSION", "dequnat")
    with pytest.raises(ValueError) as want:
        pallas_layer.fusion_enabled()
    with pytest.raises(ValueError) as got:
        Engine(_port_spec(SPECS["spec"]), _port_host("spec"), "cpu")
    assert str(got.value) == str(want.value)
