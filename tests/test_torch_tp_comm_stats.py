"""The port's collective budget (parallel/comm_stats.py) against the JAX
package's: tp_collective_budget, collective_staging_bytes,
ici_all_gather_bytes and reference_star_bytes are equal for Llama-2
7B/13B/70B at tp 1, 2, 4 and 8, under every scheme, with f32 and Q80
buffers (and for the speculative t_len widening); tp_scheme reads
DLLAMA_TP_SCHEME the same way."""

import pytest

from distributed_llama_tpu_torch.models.spec import TransformerSpec
from distributed_llama_tpu_torch.ops.quants import FloatType
from distributed_llama_tpu_torch.parallel import comm_stats as cs

MODELS = {"7b": dict(dim=4096, hidden_dim=11008, n_layers=32, n_heads=32,
                     n_kv_heads=32, vocab_size=32000, seq_len=2048),
          "13b": dict(dim=5120, hidden_dim=13824, n_layers=40, n_heads=40,
                      n_kv_heads=40, vocab_size=32000, seq_len=2048),
          "70b": dict(dim=8192, hidden_dim=28672, n_layers=80, n_heads=64,
                      n_kv_heads=8, vocab_size=32000, seq_len=2048)}
BUFFERS = {"f32": FloatType.F32, "q80": FloatType.Q80}


def _specs(model, buf):
    from distributed_llama_tpu.models.spec import TransformerSpec as JSpec

    kw = MODELS[model]
    return (TransformerSpec(**kw, buffer_float_type=BUFFERS[buf]),
            JSpec(**kw, buffer_float_type=int(BUFFERS[buf])))


@pytest.mark.parametrize("buf", sorted(BUFFERS))
@pytest.mark.parametrize("scheme", cs.SCHEMES)
@pytest.mark.parametrize("tp", [1, 2, 4, 8])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_budget_equals_the_jax_package(model, tp, scheme, buf):
    from distributed_llama_tpu.parallel import comm_stats as jcs

    spec, jspec = _specs(model, buf)
    for t_len in (1, 4):
        mine = cs.tp_collective_budget(spec, tp, scheme, t_len)
        theirs = jcs.tp_collective_budget(jspec, tp, scheme, t_len)
        assert mine.entries == theirs.entries
        assert mine.n_collectives == theirs.n_collectives
        assert mine.moved_bytes == theirs.moved_bytes
        assert cs.collective_staging_bytes(spec, tp, scheme, t_len) == \
            jcs.collective_staging_bytes(jspec, tp, scheme, t_len)
    assert cs.ici_all_gather_bytes(spec, tp, scheme) == \
        cs.CommStats(*jcs.ici_all_gather_bytes(jspec, tp, scheme).__dict__
                     .values())
    star = jcs.reference_star_bytes(jspec, tp)
    assert cs.reference_star_bytes(spec, tp) == cs.CommStats(
        star.sent_bytes, star.recv_bytes)


@pytest.mark.parametrize("value", [None, "ref", "fused", "overlap", "ring"])
def test_tp_scheme_reads_the_env_like_the_jax_package(monkeypatch, value):
    from distributed_llama_tpu.parallel import comm_stats as jcs

    if value is None:
        monkeypatch.delenv("DLLAMA_TP_SCHEME", raising=False)
    else:
        monkeypatch.setenv("DLLAMA_TP_SCHEME", value)
    if value == "ring":
        with pytest.raises(ValueError, match="DLLAMA_TP_SCHEME") as mine:
            cs.tp_scheme()
        with pytest.raises(ValueError) as theirs:
            jcs.tp_scheme()
        assert str(mine.value) == str(theirs.value)
    else:
        assert cs.tp_scheme() == jcs.tp_scheme() == (value or "fused")
    for kind in ("ppermute", "all_gather", "psum", "reduce_scatter"):
        for n in (1, 2, 8):
            assert cs.collective_hops(kind, n) == jcs.collective_hops(kind, n)
