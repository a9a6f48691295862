"""The port's fused decode-layer ops (ops/layer.py) against the JAX
package's Pallas kernels (ops/pallas_layer.py, interpret mode as
tests/test_pallas_layer.py runs them, DLLAMA_Q40_KERNEL=pallas).

Both sides get the same numpy weights (the JAX package's synth_params):
JAX packs them into its d-major kernel stacks (the megakernel reads the
block-permuted ``wo_mega``), the port keeps the codec layout
(params_from_reference). The inputs are made from a seed with numpy. On the
CPU the port's wrappers take their plain versions. Tolerance: the JAX
test's own, outputs atol 5e-4 + rtol 1e-4 (the Pallas kernels sum in their
own order, and its cos/sin differ from torch's by a few 1e-5 absolute at
RoPE angles up to pos), cache k/v atol 1e-4.
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu.models.spec import TransformerSpec
from distributed_llama_tpu.ops.quants import FloatType

ATOL, RTOL = 5e-4, 1e-4
CACHE_ATOL = 1e-4

# the shapes of tests/test_pallas_layer.py: SPEC (GQA at head size 16),
# MEGA_MHA and MEGA_GQA (head size 128, the megakernel's)
SPECS = {
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
LAYER = 1


def _port_spec(spec, **kw):
    from distributed_llama_tpu_torch.models.spec import \
        TransformerSpec as PortSpec

    fields = ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads",
              "vocab_size", "seq_len", "weights_float_type",
              "buffer_float_type")
    return PortSpec(**{**{f: getattr(spec, f) for f in fields}, **kw})


@pytest.fixture(scope="module")
def models():
    """name -> (spec, numpy host tree, JAX packed tree, port layer view of
    LAYER, port RoPE frequencies), built once."""
    import os

    import jax
    import jax.numpy as jnp

    from distributed_llama_tpu.models.synth import synth_params
    from distributed_llama_tpu.ops.linear import (fuse_q40_layer_matmuls,
                                                  pack_q40_params)
    from distributed_llama_tpu.ops.pallas_layer import prepare_mega_params
    from distributed_llama_tpu_torch.models import llama

    saved = os.environ.get("DLLAMA_LAYER_FUSION")
    os.environ["DLLAMA_LAYER_FUSION"] = "on"  # prepare_mega_params reads it
    try:
        out = {}
        for name, spec in SPECS.items():
            host = synth_params(spec, q40=True, seed=11, scale=0.2)
            packed = fuse_q40_layer_matmuls(
                pack_q40_params(host, enable=True, allow_nb_major=False))
            packed = jax.tree_util.tree_map(
                jnp.asarray, prepare_mega_params(spec, packed))
            dev = llama.params_from_reference(host, "cpu")
            model = llama.Llama(_port_spec(spec), dev)
            out[name] = (spec, host, packed, model.layers[LAYER],
                         model.freq)
    finally:
        if saved is None:
            os.environ.pop("DLLAMA_LAYER_FUSION", None)
        else:
            os.environ["DLLAMA_LAYER_FUSION"] = saved
    return out


def _x(spec, seed):
    return np.random.default_rng(seed).standard_normal(
        spec.dim).astype(np.float32)


def _pos(p):
    return torch.tensor([p], dtype=torch.int32)


@pytest.mark.parametrize("pos", [0, 5, 13])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_head_matches_jax(models, monkeypatch, name, pos):
    """q40_head_fused: rmsnorm -> wqkv -> RoPE on q and k, v as it is."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops import pallas_layer
    from distributed_llama_tpu_torch.ops.layer import q40_head_fused

    monkeypatch.setenv("DLLAMA_Q40_KERNEL", "pallas")
    spec, host, packed, lw, freq = models[name]
    x = _x(spec, pos)
    freq_col, even_col = pallas_layer.rope_freq_cols(spec)
    want = np.asarray(pallas_layer.q40_head_fused(
        spec, packed["wqkv"], jnp.asarray(host["rms_att"][LAYER])[:, None],
        jnp.asarray(freq_col), jnp.asarray(even_col),
        jnp.asarray(x)[:, None], LAYER, pos, interpret=True))[:, 0]
    got = q40_head_fused(torch.from_numpy(x)[None], lw["wqkv"],
                         lw["rms_att"], freq, _pos(pos))
    assert got.shape == (1, spec.dim + 2 * spec.kv_dim)
    np.testing.assert_allclose(got[0].numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_tail_matches_jax(models, monkeypatch, name):
    """q40_tail_fused: wo + residual -> rmsnorm -> w13 -> silu * mul -> w2 +
    residual."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops import pallas_layer
    from distributed_llama_tpu_torch.ops.layer import q40_tail_fused

    monkeypatch.setenv("DLLAMA_Q40_KERNEL", "pallas")
    spec, host, packed, lw, _ = models[name]
    ao, x = _x(spec, 1), _x(spec, 2)
    want = np.asarray(pallas_layer.q40_tail_fused(
        spec, packed["wo"], packed["w13"], packed["w2"],
        jnp.asarray(host["rms_ffn"][LAYER])[:, None],
        jnp.asarray(ao)[:, None], jnp.asarray(x)[:, None], LAYER,
        interpret=True))[:, 0]
    got = q40_tail_fused(torch.from_numpy(ao)[None], torch.from_numpy(x)[None],
                         lw["wo"], lw["w13"], lw["w2"], lw["rms_ffn"])
    assert got.shape == (1, spec.dim)
    np.testing.assert_allclose(got[0].numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("pos", [0, 9])
@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["mega_mha", "mega_gqa"])
def test_mega_matches_jax(models, monkeypatch, name, cache, pos):
    """q40_layer_mega over a cache holding history at 0..pos-1 (and junk
    past pos): the layer output and the whole cache afterwards, k and v
    written at (LAYER, pos) in the cache dtype. JAX's megakernel reads its
    permuted wo stack, the port's the codec wo."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops import pallas_layer
    from distributed_llama_tpu_torch.ops.layer import q40_layer_mega

    monkeypatch.setenv("DLLAMA_Q40_KERNEL", "pallas")
    spec, host, packed, lw, freq = models[name]
    x = _x(spec, 3)
    shape = (spec.n_layers, spec.seq_len, spec.n_kv_heads, spec.head_size)
    rng = np.random.default_rng(7)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if cache == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    freq_col, even_col = pallas_layer.rope_freq_cols(spec)
    x_out, k_new, v_new = pallas_layer.q40_layer_mega(
        spec, packed["wqkv"], packed["wo_mega"], packed["w13"],
        packed["w2"], jnp.asarray(host["rms_att"][LAYER])[:, None],
        jnp.asarray(host["rms_ffn"][LAYER])[:, None], jnp.asarray(freq_col),
        jnp.asarray(even_col), jnp.asarray(x)[:, None],
        jnp.asarray(k0).astype(jdt), jnp.asarray(v0).astype(jdt), LAYER, pos,
        interpret=True)
    k_all = torch.from_numpy(k0).to(tdt)
    v_all = torch.from_numpy(v0).to(tdt)
    got = q40_layer_mega(torch.from_numpy(x)[None], lw["wqkv"], lw["wo"],
                         lw["w13"], lw["w2"], lw["rms_att"], lw["rms_ffn"],
                         freq, k_all, v_all, LAYER, _pos(pos), spec.kv_mul)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(x_out)[:, 0],
                               atol=ATOL, rtol=RTOL)
    for mine, theirs in ((k_all, k_new), (v_all, v_new)):
        np.testing.assert_allclose(
            mine.float().numpy(), np.asarray(theirs.astype(jnp.float32)),
            atol=CACHE_ATOL)


@pytest.mark.parametrize("value", [None, "", "auto", "off", "on", "headtail",
                                   "dequnat"])
def test_fusion_mode_reads_the_environment_as_jax(monkeypatch, value):
    """fusion_mode gives the JAX package's mode, or its ValueError."""
    from distributed_llama_tpu.ops import pallas_layer
    from distributed_llama_tpu_torch.ops import layer

    if value is None:
        monkeypatch.delenv("DLLAMA_LAYER_FUSION", raising=False)
    else:
        monkeypatch.setenv("DLLAMA_LAYER_FUSION", value)
    try:
        want = pallas_layer.fusion_mode()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            layer.fusion_mode()
        assert str(got.value) == str(e)
        return
    assert layer.fusion_mode() == want
    assert layer.fused(want) == pallas_layer.fusion_enabled()


@pytest.mark.parametrize("name", sorted(SPECS) + ["7b", "q80"])
def test_supports_and_mega_gate_as_jax(models, monkeypatch, name):
    """supports (q80 buffers off; 32-value blocks; even head size) and
    mega_supported (head size 128 and an attention chunk) decide as the
    JAX package's supports and _mega_shapes_ok do."""
    from distributed_llama_tpu.models.synth import llama2_7b_spec
    from distributed_llama_tpu.ops import pallas_layer
    from distributed_llama_tpu_torch.ops import layer

    monkeypatch.setenv("DLLAMA_Q40_KERNEL", "pallas")
    spec, host, packed, lw, _ = models["spec" if name in ("7b", "q80")
                                       else name]
    if name == "q80":
        spec = TransformerSpec(**{**spec.__dict__,
                                  "buffer_float_type": FloatType.Q80})
    port = _port_spec(spec)
    port_params = {k: lw[k] for k in ("wqkv", "wo", "w13", "w2")}
    assert layer.supports(port, port_params) == \
        pallas_layer.supports(spec, packed)
    if name == "7b":
        spec = llama2_7b_spec()
        port = _port_spec(spec)
    assert layer.mega_supported(port) == pallas_layer._mega_shapes_ok(spec)
    assert not layer.supports(port, {k: v for k, v in port_params.items()
                                     if k != "w13"})
