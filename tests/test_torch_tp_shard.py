"""The port's weight bands (parallel/tp.shard_params and load_model_bands)
against the JAX package's shard_params: each rank's band is its
addressable shard there, bit for bit, under ref and fused, F32 and Q40
weights, and a GQA model; the rejection cases twin
tests/test_tensor_parallel.py's test_tp_rejects_indivisible and
test_fused_rejects_unsplittable_q40_blocks."""

import numpy as np
import pytest

from distributed_llama_tpu_torch.io.loader import Q40Weight
from distributed_llama_tpu_torch.models.spec import TransformerSpec
from distributed_llama_tpu_torch.ops.quants import FloatType
from distributed_llama_tpu_torch.parallel import tp

# GQA: 8 query heads over 4 kv heads; hidden 256 = 8 Q40 blocks
GQA = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
           vocab_size=96, seq_len=16)


def _tree(spec, q40, seed=3):
    from distributed_llama_tpu_torch.models.synth import synth_params

    return synth_params(spec, q40, seed=seed)


def _jax_shards(tree, n, scheme, q40):
    """name -> [per-rank numpy leaves] of the JAX package's shard_params."""
    from distributed_llama_tpu.io.loader import Q40Weight as JQ40
    from distributed_llama_tpu.parallel import make_mesh, shard_params

    mesh = make_mesh(tp=n)
    jtree = {k: JQ40(*v) if isinstance(v, Q40Weight) else v
             for k, v in tree.items()}
    placed = shard_params(jtree, mesh, scheme=scheme)
    devices = list(mesh.devices.flat)

    def per_rank(arr):
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        return [by_dev[d] for d in devices]

    out = {}
    for name, val in placed.items():
        if isinstance(val, JQ40):
            out[name] = list(zip(per_rank(val.qs), per_rank(val.d16)))
        else:
            out[name] = per_rank(val)
    return out


def _equal(port, jax_leaf):
    if isinstance(port, Q40Weight):
        np.testing.assert_array_equal(port.qs, jax_leaf[0])
        np.testing.assert_array_equal(port.d16, jax_leaf[1])
        assert port.qs.flags.c_contiguous and port.d16.flags.c_contiguous
    else:
        np.testing.assert_array_equal(port, jax_leaf)
        assert port.flags.c_contiguous


@pytest.mark.parametrize("q40", [False, True], ids=["f32", "q40"])
@pytest.mark.parametrize("scheme", ["ref", "fused", "overlap"])
@pytest.mark.parametrize("n", [2, 4])
def test_bands_are_the_jax_shards(n, scheme, q40, tmp_path):
    from distributed_llama_tpu_torch.io.loader import write_model

    wft = FloatType.Q40 if q40 else FloatType.F32
    spec = TransformerSpec(**GQA, weights_float_type=wft)
    tree = _tree(spec, q40)
    want = _jax_shards(tree, n, "fused" if scheme == "overlap" else scheme,
                       q40)
    path = str(tmp_path / "m.bin")
    write_model(path, spec, tree)
    for rank in range(n):
        bands = tp.shard_params(tree, rank, n, scheme)
        _, read = tp.load_model_bands(path, rank, n, scheme, wft)
        assert sorted(bands) == sorted(want) == sorted(read)
        for name in bands:
            _equal(bands[name], want[name][rank])
            _equal(read[name], want[name][rank])
    # the band axes: wo/w2 along their input (block) axis under fused
    specs = tp.param_specs(tree, scheme)
    axis = "in" if scheme != "ref" else "out"
    assert specs["wo"] == specs["w2"] == axis
    assert specs["wq"] == specs["wcls"] == "out" and specs["rms_att"] is None


def test_rank_fuses_its_own_bands():
    """A rank's wqkv is [its q | its k | its v] bands (what the layer splits),
    never a band of the whole fused tree."""
    from distributed_llama_tpu_torch.models.llama import params_to_device

    spec = TransformerSpec(**GQA, weights_float_type=FloatType.Q40)
    tree = _tree(spec, True)
    with pytest.raises(KeyError, match="never banded whole"):
        tp.param_specs({**tree, "wqkv": tree["wq"]})
    for rank in range(2):
        dev = params_to_device(tp.shard_params(tree, rank, 2, "fused"), "cpu")
        q, k = 64, 32  # dim/2, kv_dim/2 rows
        for i, name in enumerate(("wq", "wk", "wv")):
            lo = (0, q, q + k)[i]
            rows = (q, k, k)[i]
            band = tree[name].qs[:, rank * rows:(rank + 1) * rows]
            np.testing.assert_array_equal(
                dev["wqkv"].qs[:, lo:lo + rows].numpy(), band)


def test_sharded_forward_takes_bands_not_the_whole_tree():
    """make_sharded_forward takes a rank's bands: a whole tree raises
    before anything moves to the device."""
    import torch

    from distributed_llama_tpu_torch.parallel.mesh import TPGroup

    spec = TransformerSpec(**GQA, weights_float_type=FloatType.Q40)
    tree = _tree(spec, True)
    group = TPGroup(0, 2, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="not the whole tree"):
        tp.make_sharded_forward(spec, tree, group, "fused")


def test_fused_rejects_unsplittable_q40_blocks():
    spec = TransformerSpec(dim=64, hidden_dim=160, n_layers=1, n_heads=2,
                           n_kv_heads=2, vocab_size=64, seq_len=8)
    p = _tree(TransformerSpec(**{**spec.__dict__,
                                 "weights_float_type": FloatType.Q40}), True)
    with pytest.raises(ValueError, match="32-multiple"):
        tp.shard_params(p, 0, 2, scheme="fused")
    assert tp.shard_params(p, 0, 2, scheme="ref")  # ref: fine
    with pytest.raises(ValueError, match="32-multiple"):
        tp.validate_sharding(TransformerSpec(
            **{**spec.__dict__, "weights_float_type": FloatType.Q40}), 2,
            "overlap")


@pytest.mark.parametrize("bad,n,match", [
    (dict(dim=64, hidden_dim=150, n_layers=1, n_heads=8, n_kv_heads=8,
          vocab_size=96, seq_len=16), 4, "hidden_dim"),
    (dict(dim=64, hidden_dim=160, n_layers=1, n_heads=4, n_kv_heads=2,
          vocab_size=96, seq_len=16), 4, "n_kv_heads"),
    (dict(dim=64, hidden_dim=160, n_layers=1, n_heads=6, n_kv_heads=6,
          vocab_size=96, seq_len=16), 4, "n_heads"),
    (dict(dim=64, hidden_dim=160, n_layers=1, n_heads=4, n_kv_heads=4,
          vocab_size=90, seq_len=16), 4, "vocab_size"),
    (dict(dim=64, hidden_dim=128, n_layers=1, n_heads=4, n_kv_heads=4,
          vocab_size=96, seq_len=16, buffer_float_type=FloatType.Q80), 4,
     "Q80 buffer needs dim/tp"),
], ids=["hidden", "kv-heads", "heads", "vocab", "q80-dim"])
def test_tp_rejects_indivisible(bad, n, match):
    """The JAX package's validate_sharding messages, before any load."""
    from distributed_llama_tpu.models.spec import TransformerSpec as JSpec
    from distributed_llama_tpu.parallel import make_mesh, validate_sharding

    spec = TransformerSpec(**bad)
    with pytest.raises(ValueError, match=match) as mine:
        tp.validate_sharding(spec, n, "fused")
    with pytest.raises(ValueError) as theirs:
        validate_sharding(JSpec(**{**bad, "buffer_float_type": int(
            bad.get("buffer_float_type", 0))}), make_mesh(tp=n), "fused")
    assert str(mine.value) == str(theirs.value)


def test_kv_quant_and_scheme_rules():
    spec = TransformerSpec(dim=64, hidden_dim=128, n_layers=1, n_heads=4,
                           n_kv_heads=4, vocab_size=96, seq_len=16)
    tp.validate_kv_quant(spec, 2, "q8")  # 2 heads x 16 = 32 values
    with pytest.raises(ValueError, match="32-multiple"):
        tp.validate_kv_quant(spec, 4, "q8")
    with pytest.raises(ValueError, match="f32|q8"):
        tp.validate_kv_quant(spec, 2, "q4")
    assert tp._effective_scheme("overlap", 1) == "fused"
    assert tp._effective_scheme("overlap", 2) == "overlap"
    local = tp.local_spec(TransformerSpec(**GQA), 4)
    assert (local.dim, local.n_heads, local.n_kv_heads, local.hidden_dim,
            local.vocab_size) == (32, 2, 1, 64, 24)
    assert local.head_size == 16 and local.kv_mul == 2


def test_shard_cache_takes_the_kv_head_band():
    import torch

    from distributed_llama_tpu_torch.models.llama import (KVCache,
                                                          PagedKVQ8)

    k = torch.arange(2 * 4 * 4 * 8, dtype=torch.float32).reshape(2, 4, 4, 8)
    band = tp.shard_cache(KVCache(k, k + 1), 1, 2)
    assert torch.equal(band.k, k[:, :, 2:]) and band.k.is_contiguous()
    codes = torch.zeros((1, 3, 2, 4, 16), dtype=torch.int8)
    deltas = torch.arange(1 * 3 * 2 * 2, dtype=torch.float16).reshape(
        1, 3, 2, 2)
    q8 = tp.shard_cache_paged(PagedKVQ8(codes, deltas, codes, deltas), 1, 2)
    assert q8.kq.shape == (1, 3, 2, 2, 16)
    assert torch.equal(q8.kd, deltas[..., 1:])
    rows = dict(tp.expected_shard_names(_tree(TransformerSpec(**GQA), True),
                                        "fused"))
    assert rows["wq.qs"] == {1: ("tp",)} and rows["wo.qs"] == {2: ("tp",)}
    assert rows["wcls.d16"] == {0: ("tp",)} and rows["rms_att"] == {}
