"""The KV tiers under tensor parallelism, on the CPU: two gloo ranks of the
port's continuous engine (``mesh=`` a TPGroup), each holding its kv-head
band of the pool, demote and promote their own band's pages through host
and disk tiers (each rank's disk tier in its own ``rank<r>`` directory)
and, deciding in lockstep, keep the same tier books. Their streams, f32
and Q8 pages, equal the port's tp 1 tiered engine's, its untiered one's,
and the JAX package's tiered engine on a tp 2 mesh (the twin of
tests/test_tiering.py::test_engine_streams_invisible_under_tp_mesh)."""

import pickle

import numpy as np
import pytest
import torch

from distributed_llama_tpu.models.spec import TransformerSpec
from distributed_llama_tpu.models.synth import synth_params
from test_torch_tp import spawn_ranks

SPEC = TransformerSpec(dim=64, hidden_dim=160, n_layers=2, n_heads=4,
                       n_kv_heads=2, vocab_size=128, seq_len=32)
PS = 4
QUANTS = ("f32", "q8")
_FIELDS = ("dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads",
           "vocab_size", "seq_len")
# q8 at tp 2 needs 32-value blocks inside a rank's band: n_kv/2 * hs = 16
# values at this width, so Q8 pages run on a 4-kv-head spec
Q8_SPEC = TransformerSpec(dim=128, hidden_dim=256, n_layers=2, n_heads=4,
                          n_kv_heads=4, vocab_size=128, seq_len=32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(kv_quant):
    return Q8_SPEC if kv_quant == "q8" else SPEC


def _port_spec(spec):
    from distributed_llama_tpu_torch.models.spec import TransformerSpec as P

    return P(**{f: getattr(spec, f) for f in _FIELDS})


def _host(spec):
    return {k: np.asarray(v) for k, v in
            synth_params(spec, q40=False, seed=4, scale=0.3).items()}


def _waves():
    return [[[1] + [(7 * i + j) % 90 + 5 for j in range(2 * PS)]
             + [t + i % 40] for i in range(6)] for t in (3, 9)]


def _run(kv_quant, disk, group=None, tiered=True):
    """Two waves through one engine: (streams, tier books, audit). The
    tp 1 engine stages inline (kv_tier_async=False), so its promotions
    land at the step boundary the tp ranks' lockstep lands them."""
    from distributed_llama_tpu_torch.parallel.tp import shard_params
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine

    spec = _spec(kv_quant)
    params, kw = _host(spec), {}
    if group is not None:
        params = shard_params(params, group.rank, group.size, "fused")
        kw = dict(mesh=group, scheme="fused")
    if tiered:
        kw.update(kv_pages=8, kv_host_pages=6, kv_disk_dir=disk,
                  kv_tier_async=group is not None)
    else:
        kw.update(kv_pages=64)
    eng = ContinuousEngine(_port_spec(spec), params, 2, 0.0, 0.9, 3,
                           prefill_chunk=PS, page_size=PS,
                           kv_quant=kv_quant, device="cpu", **kw)
    outs = [eng.run(w, 16)[0] for w in _waves()]
    a = eng.allocator
    books = (dict(a.demotions), dict(a.promotions),
             dict(a.tokens_saved_by_tier), a.evictions)
    audit = eng.audit_pages()
    eng.close()
    return outs, books, audit


def _rank_main(rank, world, port, out, disk):
    from distributed_llama_tpu_torch.parallel.mesh import close, init_rank

    g = init_rank(rank, world, f"tcp://localhost:{port}", "cpu")
    res = {}
    with torch.inference_mode():
        for q in QUANTS:
            res[q] = _run(q, f"{disk}/{q}", g)
    with open(f"{out}.{rank}", "wb") as fh:
        pickle.dump(res, fh)
    if rank == 0:
        with open(out, "wb") as fh:
            pickle.dump(res, fh)
    close(g)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tier_tp")
    out = d / "tp2.pkl"
    spawn_ranks(_rank_main, 2, out, str(d / "kv"))
    got = []
    for r in range(2):
        with open(f"{out}.{r}", "rb") as fh:
            got.append(pickle.load(fh))
    return got, d


@pytest.mark.parametrize("kv_quant", QUANTS)
def test_tp2_tiers_keep_the_tp1_streams(ranks, tmp_path, kv_quant):
    (r0, r1), d = ranks
    outs, books, audit = r0[kv_quant]
    assert r1[kv_quant] == r0[kv_quant]  # lockstep: the same books
    assert audit == []
    assert sum(books[0].values()) > 0 and sum(books[1].values()) > 0
    with torch.inference_mode():
        one = _run(kv_quant, str(tmp_path / "one"))
        plain = _run(kv_quant, None, tiered=False)
    assert outs == one[0] == plain[0]
    assert books == one[1]  # tp 1 decides the same demotions
    assert (d / "kv" / kv_quant / "rank0").is_dir()
    assert (d / "kv" / kv_quant / "rank1").is_dir()


@pytest.mark.parametrize("kv_quant", QUANTS)
def test_tp2_tiers_equal_the_jax_tp_mesh(ranks, tmp_path, kv_quant):
    from distributed_llama_tpu.parallel import make_mesh
    from distributed_llama_tpu.runtime.continuous import ContinuousEngine

    spec = _spec(kv_quant)
    eng = ContinuousEngine(spec, synth_params(spec, q40=False, seed=4,
                                              scale=0.3),
                           slots=2, temperature=0.0, topp=0.9, seed=3,
                           prefill_chunk=PS, page_size=PS, kv_pages=8,
                           kv_host_pages=6, kv_disk_dir=str(tmp_path),
                           kv_quant=kv_quant, mesh=make_mesh(tp=2),
                           use_native_sampler=False)
    want = [eng.run(w, 16)[0] for w in _waves()]
    eng.close()
    assert ranks[0][0][kv_quant][0] == want
    assert sum(eng.allocator.promotions.values()) > 0
