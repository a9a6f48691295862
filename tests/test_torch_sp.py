"""Sequence parallelism of the port (parallel/tp.TPLlama over an sp x tp
group of gloo ranks on the CPU, parallel/mesh.init_mesh) against the JAX
package's make_sharded_forward at the same (sp, tp) on a mesh of host
devices (the twin of tests/test_sequence_parallel.py's decode parity).

At (sp, tp) in {(2, 1), (4, 1), (2, 2)} on its 32-position model: a
7-token prefill that straddles the sp chunks (16 or 8 positions), one
decode step, then a 12-token prefill from position 8 (T > 8: the
blockwise walk over each chunk's live blocks) and a decode step; logits
within 2e-5 abs of JAX's (tests/test_sequence_parallel.py's tolerance).
The lockstep batch step (``forward_batch`` at per-row clocks) equals the
single-sequence calls. Every call's sp collectives are 3 a layer (one
pmax, two psums) with comm_stats.sp_lse_bytes' bytes, and the tp ones
equal comm_stats.tp_collective_budget as without sp."""

import numpy as np
import pytest
import torch
from test_torch_tp import spawn_ranks

from distributed_llama_tpu_torch.models.spec import TransformerSpec

BASE = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=8, n_kv_heads=4,
            vocab_size=96, seq_len=32)
MESHES = [(2, 1), (4, 1), (2, 2)]
CALLS = [([1, 5, 9, 2, 17, 3, 8], 0), ([4], 7),
         ([6, 2, 11, 3, 9, 1, 7, 5, 13, 2, 8, 4], 8), ([10], 20)]
ATOL = 2e-5


def _tree(seed=11, scale=0.1):
    """tests/test_sequence_parallel.py's seeded parameters."""
    spec = TransformerSpec(**BASE)
    rng = np.random.default_rng(seed)

    def t(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"tok_embedding": t(spec.vocab_size, spec.dim),
         "rms_final": 1 + t(spec.dim), "wcls": t(spec.vocab_size, spec.dim),
         "rms_att": 1 + t(spec.n_layers, spec.dim),
         "rms_ffn": 1 + t(spec.n_layers, spec.dim)}
    for name, shape in spec.layer_matmul_shapes():
        p[name] = t(spec.n_layers, *shape)
    return p


def _rank_main(rank, world, port, out, sp, tp):
    """One rank of sp x tp: the CALLS (logits and census per call), then
    a 3-row batch step at ragged clocks beside the rows' single calls."""
    import pickle

    from distributed_llama_tpu_torch.models.llama import (init_cache,
                                                          init_cache_batch)
    from distributed_llama_tpu_torch.parallel import collectives as C
    from distributed_llama_tpu_torch.parallel.mesh import close, init_mesh
    from distributed_llama_tpu_torch.parallel.tp import (make_sharded_forward,
                                                         shard_params)

    g = init_mesh(rank, sp, tp, f"tcp://localhost:{port}", "cpu")
    spec = TransformerSpec(**BASE)
    model = make_sharded_forward(spec, shard_params(_tree(), g.rank, tp),
                                 g, "fused")
    res = {"calls": [], "census": []}
    with torch.inference_mode():
        cache = init_cache(model.spec, "cpu")
        for tokens, pos in CALLS:
            C.CENSUS.reset()
            res["calls"].append(model(cache, tokens, pos).numpy())
            res["census"].append({k: list(v) for k, v in
                                  C.CENSUS.counts.items()})
        # the batch step: rows at clocks 3, 9, 17 (each after its prefix)
        rows = [[2, 7, 1], [3, 1, 4, 1, 5, 9, 2, 6, 5], list(range(1, 18))]
        bcache = init_cache_batch(model.spec, len(rows), "cpu")
        single = []
        for b, r in enumerate(rows):
            c1 = init_cache(model.spec, "cpu")
            model(c1, r, 0, logits=False)
            bcache.k[:, b].copy_(c1.k)
            bcache.v[:, b].copy_(c1.v)
            single.append(model(c1, 12, len(r)).numpy()[0])
        C.CENSUS.reset()
        got = model.forward_batch(bcache, torch.full((3,), 12),
                                  torch.tensor([len(r) for r in rows],
                                               dtype=torch.int32))
        res["batch"] = (got.numpy(), np.stack(single))
        res["batch_census"] = dict(C.CENSUS.counts)
    if rank == 0:
        with open(out, "wb") as fh:
            pickle.dump(res, fh)
    close(g)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sp")
    return {(sp, tp): spawn_ranks(_rank_main, sp * tp,
                                  d / f"sp{sp}tp{tp}.pkl", sp, tp)
            for sp, tp in MESHES}


def _jax_logits(sp, tp):
    import jax.numpy as jnp

    from distributed_llama_tpu.models.llama import init_cache
    from distributed_llama_tpu.models.spec import TransformerSpec as JSpec
    from distributed_llama_tpu.parallel import (make_mesh,
                                                make_sharded_forward,
                                                shard_cache, shard_params)

    spec = JSpec(**BASE)
    mesh = make_mesh(sp=sp, tp=tp)
    fwd = make_sharded_forward(spec, mesh, scheme="fused")
    params = shard_params(_tree(), mesh, scheme="fused")
    cache = shard_cache(init_cache(spec), mesh)
    out = []
    for tokens, pos in CALLS:
        got, cache = fwd(params, cache, jnp.asarray(tokens, jnp.int32),
                         jnp.int32(pos))
        out.append(np.asarray(got))
    return out


@pytest.mark.parametrize("sp,tp", MESHES)
def test_sp_logits_match_jax(runs, sp, tp):
    want = _jax_logits(sp, tp)
    for got, jx, (tokens, _) in zip(runs[(sp, tp)]["calls"], want, CALLS):
        assert got.shape == (len(tokens), BASE["vocab_size"])
        np.testing.assert_allclose(got, jx, rtol=0, atol=ATOL)


@pytest.mark.parametrize("sp,tp", MESHES)
def test_sp_batch_step_equals_single_calls(runs, sp, tp):
    got, single = runs[(sp, tp)]["batch"]
    np.testing.assert_allclose(got, single, rtol=0, atol=ATOL)


@pytest.mark.parametrize("sp,tp", MESHES)
def test_sp_census(runs, sp, tp):
    """3 sp collectives a layer at every call (T = 1, 7, 12 and the
    3-row batch), bytes as sp_lse_bytes; the tp kinds as the budget."""
    from distributed_llama_tpu_torch.parallel.comm_stats import (
        sp_lse_bytes, tp_collective_budget)

    spec = TransformerSpec(**BASE)
    L = spec.n_layers
    r = runs[(sp, tp)]
    for counts, t_len in [*zip(r["census"], [len(c[0]) for c in CALLS]),
                          (r["batch_census"], 3)]:
        assert counts["sp_pmax"][0] == L and counts["sp_psum"][0] == 2 * L
        sp_bytes = counts["sp_pmax"][1] + counts["sp_psum"][1]
        assert sp_bytes == sp_lse_bytes(spec, sp, tp, t_len).sent_bytes
        tp_counts = {k: c for k, (c, _) in counts.items()
                     if not k.startswith("sp_")}
        if tp > 1:
            budget = tp_collective_budget(spec, tp, "fused", t_len=t_len)
            assert tp_counts == budget.kind_counts()
        else:
            assert tp_counts == {}


def test_sp_refusals(runs):
    """The paged, verify and mixed programs and the overlap scheme refuse
    sp > 1 with the JAX package's messages (before any collective)."""
    from distributed_llama_tpu.parallel import make_mesh
    from distributed_llama_tpu.parallel import tp as jtp
    from distributed_llama_tpu.models.spec import TransformerSpec as JSpec
    from distributed_llama_tpu_torch.parallel import tp as ptp
    from distributed_llama_tpu_torch.parallel.mesh import TPGroup

    jspec, spec = JSpec(**BASE), TransformerSpec(**BASE)
    mesh = make_mesh(sp=2, tp=1)
    group = TPGroup(0, 1, None, torch.device("cpu"), 0, 2, None)
    model = ptp.make_sharded_forward(spec, _tree(), group, "fused")
    for jfn, method in ((jtp.make_sharded_forward_batch_paged,
                         model.forward_batch_paged),
                        (jtp.make_sharded_verify,
                         model.forward_batch_spec_paged),
                        (jtp.make_sharded_mixed,
                         model.forward_batch_mixed_paged)):
        with pytest.raises(ValueError) as want:
            jfn(jspec, mesh, 4)
        with pytest.raises(ValueError) as got:
            method(None, None, None, None)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jtp.validate_sharding(jspec, make_mesh(sp=2, tp=2), "overlap")
    with pytest.raises(ValueError) as got:
        ptp.validate_sharding(spec, 2, "overlap", 2)
    assert str(got.value) == str(want.value)
