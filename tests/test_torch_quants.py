"""Port codec and .bin format against the JAX package's: the Q40 value map
exactly (numpy and torch decode), encode bit-exactly, and model files
byte-exactly in both directions."""

import numpy as np
import pytest
import torch

from distributed_llama_tpu.io import loader as ref_loader
from distributed_llama_tpu.models.spec import TransformerSpec as RefSpec
from distributed_llama_tpu.ops import quants as ref_quants
from distributed_llama_tpu_torch.io import loader
from distributed_llama_tpu_torch.models.spec import TransformerSpec
from distributed_llama_tpu_torch.ops import quants

SHAPES = [(1, 32), (3, 64), (2, 5, 128), (7, 4096)]


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:32] = 0.0  # an all-zero block takes the where-branch
    return x


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_bit_exact(shape):
    x = _x(shape, seed=len(shape))
    qs, d = quants.quantize_q40(x)
    rqs, rd = ref_quants.quantize_q40(x)
    np.testing.assert_array_equal(qs, rqs)
    np.testing.assert_array_equal(d.view(np.uint16), rd.view(np.uint16))


@pytest.mark.parametrize("shape", SHAPES)
def test_dequantize_exact_numpy_and_torch(shape):
    qs, d = ref_quants.quantize_q40(_x(shape, seed=7))
    want = ref_quants.dequantize_q40(qs, d)
    np.testing.assert_array_equal(quants.dequantize_q40(qs, d), want)
    got = quants.dequantize_q40_torch(torch.from_numpy(qs),
                                      torch.from_numpy(d))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_nibble_order():
    """Byte j: value j in the LOW nibble, value j+16 in the HIGH nibble."""
    qs = np.zeros((1, 16), np.uint8)
    qs[0, 3] = 0x9 | (0xC << 4)          # value 3 -> code 9, value 19 -> 12
    d = np.array([2.0], np.float16)
    out = quants.dequantize_q40_torch(torch.from_numpy(qs),
                                      torch.from_numpy(d)).numpy()
    want = np.full(32, -16.0, np.float32)  # code 0 -> (0 - 8) * 2
    want[3], want[19] = (9 - 8) * 2.0, (12 - 8) * 2.0
    np.testing.assert_array_equal(out, want)


def test_wire_pack_roundtrip():
    qs, d = ref_quants.quantize_q40(_x((6, 96), seed=2))
    raw = quants.pack_q40_bytes(qs, d)
    assert raw == ref_quants.pack_q40_bytes(qs, d)
    qs2, d2 = quants.unpack_q40_bytes(raw, (6, 96))
    np.testing.assert_array_equal(qs2, qs)
    np.testing.assert_array_equal(d2.view(np.uint16), d.view(np.uint16))


@pytest.mark.parametrize("ft", ["F32", "F16", "Q40"])
def test_bin_roundtrip_matches_reference(tmp_path, ft):
    kw = dict(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=40, seq_len=8)
    spec = TransformerSpec(**kw, weights_float_type=quants.FloatType[ft])
    rspec = RefSpec(**kw, weights_float_type=ref_quants.FloatType[ft])
    assert spec.file_size() == rspec.file_size()
    from distributed_llama_tpu.models.synth import synth_params

    tensors = synth_params(rspec, q40=False, seed=4)
    mine, theirs = tmp_path / "port.bin", tmp_path / "ref.bin"
    loader.write_model(str(mine), spec, tensors)
    ref_loader.write_model(str(theirs), rspec, tensors)
    assert mine.read_bytes() == theirs.read_bytes()

    spec2, params = loader.load_model(str(theirs),
                                      weights_float_type=spec.weights_float_type)
    _, rparams = ref_loader.load_model(str(theirs),
                                       weights_float_type=rspec.weights_float_type)
    assert spec2 == spec
    assert params.keys() == rparams.keys()
    for k, v in params.items():
        r = rparams[k]
        if isinstance(v, loader.Q40Weight):
            np.testing.assert_array_equal(v.qs, r.qs)
            np.testing.assert_array_equal(v.d16, r.d16)
        else:
            assert v.dtype == r.dtype
            np.testing.assert_array_equal(v, r)
    # and the loaded tree writes back to the same bytes (Q40 leaves are
    # written as they are, F16 widens and narrows exactly)
    again = tmp_path / "again.bin"
    loader.write_model(str(again), spec, params)
    assert again.read_bytes() == theirs.read_bytes()


def test_fast_q40_tree_writes_its_codes(tmp_path):
    """synth_q40_fast's Q40Weight leaves go to the file untouched."""
    from distributed_llama_tpu_torch.models.synth import synth_q40_fast

    spec = TransformerSpec(dim=64, hidden_dim=96, n_layers=2, n_heads=4,
                           n_kv_heads=4, vocab_size=40, seq_len=8,
                           weights_float_type=quants.FloatType.Q40)
    tree = synth_q40_fast(spec, seed=9)
    path = tmp_path / "fast.bin"
    loader.write_model(str(path), spec, tree)
    _, params = loader.load_model(str(path),
                                  weights_float_type=quants.FloatType.Q40)
    for k in ("wq", "w2", "wcls"):
        np.testing.assert_array_equal(params[k].qs, tree[k].qs)
        np.testing.assert_array_equal(params[k].d16, tree[k].d16)


def test_load_rejects_wrong_size(tmp_path):
    spec = TransformerSpec(dim=64, hidden_dim=96, n_layers=1, n_heads=4,
                           n_kv_heads=4, vocab_size=40, seq_len=8)
    path = tmp_path / "short.bin"
    path.write_bytes(spec.header() + b"\0" * 100)
    with pytest.raises(ValueError, match="file size mismatch"):
        loader.load_model(str(path))


def test_7b_file_size():
    from distributed_llama_tpu_torch.models.synth import llama2_7b_spec

    assert llama2_7b_spec().file_size() == 4242882588


def _q80_input(shape, seed):
    """N(0, 1) values with an all-zero block and a block of exact .5 ties
    (amax 127, so 1/d = 1 and x * (1/d) lands on the halves)."""
    x = _x(shape, seed)
    flat = x.reshape(-1)
    if flat.size >= 64:
        flat[32:64] = np.arange(32, dtype=np.float32) - 15.5
        flat[32] = 127.0
    return x


@pytest.mark.parametrize("shape", SHAPES)
def test_q80_codec_bit_exact(shape):
    """Q80 encode/decode, numpy and torch, against the JAX package's numpy
    codec: codes and f16 deltas bit for bit, decoded values exactly."""
    x = _q80_input(shape, seed=len(shape) + 20)
    rqs, rd = ref_quants.quantize_q80(x)
    qs, d = quants.quantize_q80(x)
    np.testing.assert_array_equal(qs, rqs)
    np.testing.assert_array_equal(d.view(np.uint16), rd.view(np.uint16))
    tqs, td = quants.quantize_q80_torch(torch.from_numpy(x))
    assert tqs.dtype == torch.int8 and td.dtype == torch.float16
    np.testing.assert_array_equal(tqs.numpy(), rqs)
    np.testing.assert_array_equal(td.numpy().view(np.uint16),
                                  rd.view(np.uint16))
    want = ref_quants.dequantize_q80(rqs, rd)
    np.testing.assert_array_equal(quants.dequantize_q80(qs, d), want)
    np.testing.assert_array_equal(
        quants.dequantize_q80_torch(tqs, td).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fake_quant_q80_bit_exact_with_jax(seed):
    """ops/linear.fake_quant_q80 against the JAX package's, on random
    inputs of several scales with an all-zero block and exact .5 ties:
    equal bit for bit (same f32 arithmetic, both round ties to even)."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.linear import fake_quant_q80 as ref
    from distributed_llama_tpu_torch.ops.linear import fake_quant_q80

    rng = np.random.default_rng(seed)
    x = _q80_input((5, 256), seed) * np.float32(10.0 ** rng.uniform(-3, 3))
    x.reshape(-1)[32:64] = np.arange(32, dtype=np.float32) - 15.5
    x.reshape(-1)[32] = 127.0
    want = np.asarray(ref(jnp.asarray(x)))
    got = fake_quant_q80(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not got.reshape(-1)[:32].any()  # the zero block stays zero
