"""The port's memory model (distributed_llama_tpu_torch/analysis/
memory_model.py) against the JAX package's analysis/memory_model.py and
against the port's real device tree:

* for every config of the support matrix, the KV stripe, the page pools
  (f32, bf16, Q8), kv_tier_model's and disagg_pool_model's integers, the
  collective staging and the analytic activations equal JAX's integers;
* the weight price is JAX's q40_codec_bytes (F16: 2 B a value) plus the
  port's extra copies, of which there are none: it equals the summed
  bytes of params_to_device's tree on small Q40, F16 and GQA models, under
  every DLLAMA_LAYER_FUSION mode (the Llama module adds its RoPE table,
  priced apart);
* shard_sim.rank_memory_bytes is the report's total.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.analysis import memory_model as M
from distributed_llama_tpu_torch.analysis import shardcheck as S
from distributed_llama_tpu_torch.models.spec import TransformerSpec
from distributed_llama_tpu_torch.ops.quants import FloatType

MATRIX = [(e.model, e.wtype, e.tp, e.scheme) for e in S.SUPPORT_MATRIX
          if e.kv_quant == "f32"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    from distributed_llama_tpu.analysis import memory_model as jm
    from distributed_llama_tpu.analysis import shardcheck as js
    from distributed_llama_tpu.parallel import comm_stats as jc

    return jm, js, jc


@pytest.mark.parametrize("model,wtype,tp,scheme", MATRIX)
def test_kv_staging_and_activation_prices_equal_jax(model, wtype, tp,
                                                    scheme):
    from distributed_llama_tpu_torch.parallel.comm_stats import \
        collective_staging_bytes

    jm, js, jc = _jax()
    ps, jspec = S.model_spec(model, wtype), js.model_spec(model, wtype)
    for batch in (1, 8):
        for item in (4, 2):
            assert M.kv_cache_device_bytes(ps, tp, batch,
                                           cache_itemsize=item) == \
                jm.kv_cache_device_bytes(jspec, tp, batch,
                                         cache_itemsize=item)
    pages = M.default_kv_pages(ps, 2)
    assert pages == jm.default_kv_pages(jspec, 2)
    for kvq, item in (("f32", 4), ("f32", 2), ("q8", 4)):
        if kvq == "q8" and (ps.n_kv_heads // tp * ps.head_size) % 32:
            continue
        assert M.kv_position_bytes(ps, tp, item, kvq) == \
            jm.kv_position_bytes(jspec, tp, item, kvq)
        for scrap in (True, False):
            assert M.kv_page_pool_bytes(ps, tp, pages, 16, item, scrap,
                                        kvq) == \
                jm.kv_page_pool_bytes(jspec, tp, pages, 16, item, scrap, kvq)
    assert M.equal_hbm_kv_pages(ps, tp, pages) == \
        jm.equal_hbm_kv_pages(jspec, tp, pages)
    for t_len in (1, 4, 39):
        assert collective_staging_bytes(ps, tp, scheme, t_len=t_len) == \
            jc.collective_staging_bytes(jspec, tp, scheme, t_len=t_len)
        assert M.activation_bytes_analytic(ps, tp, t_len) == \
            jm.activation_bytes_analytic(jspec, tp, t_len)
    assert M.replicated_device_bytes(ps) == jm.replicated_device_bytes(jspec)


def _ints(d):
    """The integer leaves of a model dict (the ms are each package's
    planning constants: the port's link is not the TPU's)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _ints(v).items()})
        elif isinstance(v, int) and not isinstance(v, bool):
            out[k] = v
        elif isinstance(v, str):
            out[k] = v
    return out


@pytest.mark.parametrize("model", S.MODELS)
@pytest.mark.parametrize("kv_quant,item", [("f32", 4), ("f32", 2),
                                           ("q8", 4)])
def test_tier_and_disagg_models_equal_jax(model, kv_quant, item):
    jm, js, _ = _jax()
    ps, jspec = S.model_spec(model, "q40"), js.model_spec(model, "q40")
    for tp in (1, 2, 4, 8):
        got = M.kv_tier_model(ps, tp, 100, 40, 1 << 30, 16, item, kv_quant)
        want = jm.kv_tier_model(jspec, tp, 100, 40, 1 << 30, 16, item,
                                kv_quant)
        assert _ints(got) == _ints(want)
        got = M.disagg_pool_model(ps, tp, 64, 256, 16, item, kv_quant, 517)
        want = jm.disagg_pool_model(jspec, tp, 64, 256, 16, item, kv_quant,
                                    517)
        assert _ints(got) == _ints(want)


@pytest.mark.parametrize("model,wtype", [(m, w) for m in S.MODELS
                                         for w in S.WEIGHT_TYPES])
def test_weight_price_is_the_codec_bytes(model, wtype):
    jm, js, _ = _jax()
    ps, jspec = S.model_spec(model, wtype), js.model_spec(model, wtype)
    for tp in (1, 2, 4, 8):
        values = jm.weight_values_per_device(jspec, tp)
        assert M.weight_values_per_device(ps, tp) == values
        want = (jm.q40_codec_bytes(values) if wtype == "q40"
                else 2 * values)
        assert M.weights_device_bytes(ps, tp) == want


TREE_SPECS = {
    "q40": TransformerSpec(dim=128, hidden_dim=384, n_layers=2, n_heads=4,
                           n_kv_heads=4, vocab_size=96, seq_len=32,
                           weights_float_type=FloatType.Q40),
    "f16": TransformerSpec(dim=128, hidden_dim=384, n_layers=2, n_heads=4,
                           n_kv_heads=4, vocab_size=96, seq_len=32,
                           weights_float_type=FloatType.F16),
    "gqa": TransformerSpec(dim=256, hidden_dim=512, n_layers=2, n_heads=8,
                           n_kv_heads=2, vocab_size=96, seq_len=32,
                           weights_float_type=FloatType.Q40),
}


@pytest.mark.parametrize("name", sorted(TREE_SPECS))
@pytest.mark.parametrize("fusion", ["off", "headtail", "on"])
def test_weight_price_equals_the_device_tree(tmp_path, name, fusion):
    from distributed_llama_tpu_torch.io.loader import load_model, write_model
    from distributed_llama_tpu_torch.models.llama import (Llama, init_cache,
                                                          params_to_device)
    from distributed_llama_tpu_torch.models.synth import synth_params

    spec = TREE_SPECS[name]
    path = str(tmp_path / "m.bin")
    write_model(path, spec, synth_params(
        spec, spec.weights_float_type == FloatType.Q40, seed=4))
    lspec, host = load_model(path, weights_float_type=spec.weights_float_type)
    tree = params_to_device(host, "cpu")
    ptrs = {id(t) for t in M.tensor_leaves(tree)}
    assert M.tree_bytes(tree) == (M.weights_device_bytes(lspec, 1)
                                  + M.replicated_device_bytes(lspec))
    model = Llama(lspec, tree, fusion=fusion)
    # no fusion mode and no route keeps a second copy of any leaf
    assert {id(t) for t in M.tensor_leaves(model.params)} == ptrs
    assert model.freq.nbytes == M.rope_table_bytes(lspec)
    cache = init_cache(lspec, torch.device("cpu"))
    rep = M.device_footprint(lspec, 1, "fused")
    assert (M.tree_bytes(tree) + model.freq.nbytes
            + sum(p.nbytes for p in cache)) == rep.resident_bytes


@pytest.mark.parametrize("model", S.MODELS)
@pytest.mark.parametrize("scheme", ["ref", "fused", "overlap"])
def test_rank_memory_is_the_models_total(model, scheme):
    from distributed_llama_tpu_torch.parallel import shard_sim

    spec = S.model_spec(model, "q40")
    for tp in (1, 2, 4, 8):
        rep = M.device_footprint(spec, tp, scheme)
        assert shard_sim.rank_memory_bytes(spec, tp, scheme) == \
            rep.total_bytes
        proj = shard_sim.project_full_system(spec, tp, 10.0, scheme=scheme)
        assert proj.hbm_fits == rep.fits


def test_rank_resident_bytes_equal_synth_rank_tree():
    """One simulated tp rank's tree (shard_sim.synth_rank_q40, the tree
    chip_smoke's 70B tp 8 rank is made as) and cache are its resident
    price: bands at 18 B a block, the embedding and norms whole, its kv
    heads' cache and its rope table."""
    from distributed_llama_tpu_torch.parallel import shard_sim

    spec = TREE_SPECS["gqa"]
    for tp, scheme in ((1, "ref"), (2, "ref"), (2, "fused")):
        params = shard_sim.synth_rank_q40(spec, tp, seed=2, scheme=scheme,
                                          device="cpu")
        cache = shard_sim.init_rank_cache(spec, tp, "cpu")
        fwd = shard_sim.make_rank_forward(spec, tp, params, scheme)
        got = (M.tree_bytes(params) + fwd.freq.nbytes
               + sum(p.nbytes for p in cache))
        assert got == M.device_footprint(spec, tp, scheme).resident_bytes


def test_footprint_guards():
    spec = TREE_SPECS["q40"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        M.device_footprint(spec, 1, "fused", spec_k=4, mixed_budget=8)
    with pytest.raises(ValueError, match="PAGE planes"):
        M.device_footprint(spec, 1, "fused", kv_quant="q8")
    a = M.device_footprint(spec, 1, "fused", kv_page_size=16,
                           mixed_budget=16)
    b = M.device_footprint(spec, 1, "fused", kv_page_size=16, spec_k=16)
    assert a.total_bytes == b.total_bytes
    assert M.usable_memory_bytes() == int(M.CARD_MEMORY_BYTES * 0.9)


def test_workspaces_follow_the_kernels_plans():
    """The matmul transient is the widest split-K partial of the plans
    the wrappers take at the card's SM count, K3 adds its x halves; the
    decode scratch is attention._decode_scratch's size."""
    from distributed_llama_tpu_torch.ops import attention, q40

    spec = S.model_spec("7b", "q40")
    sms = M.H100_SMS
    want = 0
    for d, n in M._matmul_shapes(spec, 1):
        splits = q40.matvec_plan(1, d, n // 32, sms, 3)[3]
        if splits > 1:
            want = max(want, M._rounded(splits * d * 4))
    assert M.matmul_workspace_bytes(spec, 1, 1, sms) == want
    most = attention.decode_plan(spec.n_kv_heads, 1, sms)[0]
    scratch = M.decode_scratch_bytes(spec, 1, 1, sms=sms)
    assert scratch == (0 if most == 1 else
                       M._rounded(spec.n_kv_heads * most * spec.kv_mul
                                  * (spec.head_size + 2) * 4)
                       + M._rounded(spec.n_kv_heads * 4))
    t = 128
    gemm = M.matmul_workspace_bytes(spec, 1, t, sms)
    assert gemm >= M._rounded(2 * t * spec.hidden_dim * 4)
    want = 0
    for d, n in M._matmul_shapes(spec, 1):  # K3b: x rounded to bf16
        splits = q40.gemm_bf16_plan(t, d, n // 32, sms)[0]
        want = max(want, M._rounded(t * n * 2) + (
            M._rounded(splits * t * d * 4) if splits > 1 else 0))
    assert M.matmul_workspace_bytes(spec, 1, t, sms, bf16=True) == want
    assert M.kernel_workspace_bytes(spec, 1, t, sms=sms) > gemm
    assert np.isfinite(M.prefill_split_bytes(spec, 1, t, sms=sms))


@pytest.mark.parametrize("batch,t_len", [(1, 1), (1, 4), (2, 16), (8, 39)])
def test_window_scratch_is_the_window_kernels_buffer(batch, t_len):
    """The window kernels' (K6w, K7w) split buffer and tickets are
    _decode_scratch at B x t_len rows under the window plan's most
    splits, none below WINDOW_MIN_T or under a one-split plan; the
    dispatch's kernel workspace holds them beside the decode buffer."""
    from distributed_llama_tpu_torch.ops import paged_attention as pa

    sms = M.H100_SMS
    for name in ("7b", "70b"):
        spec = S.model_spec(name, "q40")
        for n_slices in (1, 2, 8):
            n_kv = spec.n_kv_heads // n_slices
            got = M.window_scratch_bytes(spec, n_slices, batch, t_len, sms)
            most = pa.window_plan(n_kv, batch, t_len, spec.kv_mul, sms)[0]
            rows = batch * t_len
            want = (0 if t_len < pa.WINDOW_MIN_T or most == 1 else
                    M._rounded(rows * n_kv * most * spec.kv_mul
                               * (spec.head_size + 2) * 4)
                    + M._rounded(rows * n_kv * 4))
            assert got == want
            whole = M.kernel_workspace_bytes(spec, n_slices, t_len, batch,
                                             sms)
            rest = (M.matmul_workspace_bytes(spec, n_slices, rows, sms)
                    + M.matvec_ticket_bytes()
                    + M.decode_scratch_bytes(spec, n_slices, batch, sms=sms)
                    + M.prefill_split_bytes(spec, n_slices, t_len, sms=sms))
            assert whole == rest + want
    # a one-row verify window of the 7B splits its keys: priced
    assert M.window_scratch_bytes(S.model_spec("7b", "q40"), 1, 1, 4,
                                  sms) > 0
