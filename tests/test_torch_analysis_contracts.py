"""The port's contracts (distributed_llama_tpu_torch/analysis/contracts.py)
on the CPU: J001's census equals comm_stats' budget and the JAX package's
J001 (analysis/jaxpr_contracts.contract_tp_collectives, traced on the
same dims) per scheme at tp 2 and 4; J002 and J003 each hold on the port
and fail on a seeded mutant."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.analysis import contracts as K


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_spec(spec):
    from distributed_llama_tpu.models.synth import small_bench_spec
    from distributed_llama_tpu.ops.quants import FloatType

    return small_bench_spec(dim=spec.dim, hidden_dim=spec.hidden_dim,
                            n_layers=spec.n_layers, n_heads=spec.n_heads,
                            n_kv_heads=spec.n_kv_heads,
                            vocab_size=spec.vocab_size,
                            seq_len=spec.seq_len,
                            weights_float_type=FloatType.F32)


@pytest.mark.parametrize("tp,scheme", K.SCHEMES_TP)
def test_j001_census_equals_budget_and_the_jax_contract(tp, scheme):
    from distributed_llama_tpu.analysis import jaxpr_contracts as jk
    from distributed_llama_tpu.parallel import comm_stats as jc

    spec = K.contract_spec()
    census = K.census_of_forward(spec, tp, scheme)
    res = K.contract_tp_collectives(spec, tp, scheme, census=census)
    assert res.ok, res.detail
    jspec = _jax_spec(spec)
    jres = jk.contract_tp_collectives(jspec, tp=tp, scheme=scheme)
    assert jres.ok, jres.detail
    want = jc.tp_collective_budget(jspec, tp, scheme)
    assert {k: c for k, (c, _) in census.items()} == want.kind_counts()
    assert sum(b for _, b in census.values()) == want.moved_bytes


def test_j001_fails_on_an_unmodeled_kind_and_a_drifted_count():
    spec = K.contract_spec()
    census = K.census_of_forward(spec, 2, "fused")
    extra = dict(census, ppermute=(1, 64))
    res = K.contract_tp_collectives(spec, 2, "fused", census=extra)
    assert not res.ok and "no comm_stats term" in res.detail
    kind, (c, b) = next(iter(census.items()))
    drift = dict(census, **{kind: (c + 1, b)})
    res = K.contract_tp_collectives(spec, 2, "fused", census=drift)
    assert not res.ok and "!= budget" in res.detail


def test_j002_holds_and_a_rebuilt_cache_fails():
    from distributed_llama_tpu_torch.models.llama import KVCache

    assert K.contract_decode_in_place().ok
    assert K.contract_decode_in_place_paged().ok

    def cloning(model, cache, token, pos):
        k = cache.k.clone()  # the seeded hazard: a plane copied a step
        model.forward(KVCache(k, cache.v), token, pos)
        cache.k.copy_(k)

    res = K.contract_decode_in_place(step=cloning)
    assert not res.ok and "aten.clone" in res.detail


def test_j003_holds_and_a_rebound_buffer_fails():
    from distributed_llama_tpu_torch.runtime.decode import DecodeLoop

    assert K.contract_decode_shape_stability().ok

    class Rebinding(DecodeLoop):
        def _step(self):
            super()._step()
            self.tokens = self.tokens.clone()  # the seeded hazard

    res = K.contract_decode_shape_stability(loop_cls=Rebinding)
    assert not res.ok and "tokens" in res.detail


def test_run_contracts_reports_every_contract():
    results = K.run_contracts("cpu")
    assert [r.contract for r in results] == ["J001"] * 6 + ["J002"] * 2 \
        + ["J003"]
    assert all(r.ok for r in results), [r.detail for r in results]
    assert np.all([r.hint for r in results])
