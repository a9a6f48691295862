"""The tensor-parallel batch steps of the port at tp=2 (gloo ranks on the
CPU) against the port at tp=1 and the JAX package's sharded steps (twin of
tests/test_batch_tp.py): the lockstep ``forward_batch`` (K5 over the
rank's kv heads) at one clock and at per-row clocks, and
``forward_batch_paged`` over f32 and Q8 page pools (K6, K7), under each
scheme; then ``generate_batch(group=...)`` and
``ContinuousEngine(mesh=...)`` (paged, admission prefill) give the tp=1
streams. Logits within 2e-5 (f32 sums in another order); Q8 pages within
1e-2 x max (a code one Q8 step apart where the k/v sums before the page
write differ in their last bit)."""

import functools
import pickle

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.models.spec import TransformerSpec
from distributed_llama_tpu_torch.ops.quants import FloatType
from test_torch_tp import _tree, spawn_ranks

BASE = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
            vocab_size=96, seq_len=32)
SPEC = TransformerSpec(**BASE, weights_float_type=FloatType.Q40)
SCHEMES = ("ref", "fused", "overlap")
KINDS = ("lockstep", "ragged", "paged-f32", "paged-q8")
B, STEPS, PS = 3, 5, 4
TOKENS = np.random.default_rng(7).integers(3, 96, (STEPS, B))
START = np.array([0, 3, 6], np.int32)  # the ragged clocks at step 0
# each row's pages: logical page j of row b -> physical page TABLE[b, j]
TABLE = (1 + np.arange(B * 8, dtype=np.int32).reshape(8, B).T[:, ::-1]
         .copy())
F32_ATOL = 2e-5
Q8_RTOL = 1e-2
PROMPTS = ["hi", "hi hi", "hi hi hi hi"]


def _port_tree():
    from distributed_llama_tpu_torch.io.loader import Q40Weight

    return _tree(SPEC, Q40Weight)


def _clock(kind, step):
    if kind == "lockstep":
        return np.full(B, step, np.int32)
    return START + step


def _steps(model, kind):
    """STEPS batch steps of one kind: logits (STEPS, B, vocab)."""
    from distributed_llama_tpu_torch.models.llama import (
        init_cache_batch, init_cache_paged, init_cache_paged_q8)

    out = []
    if kind.startswith("paged"):
        n_pages = 1 + B * 8
        cache = (init_cache_paged_q8(model.spec, n_pages, PS, "cpu")
                 if kind == "paged-q8" else
                 init_cache_paged(model.spec, n_pages, PS, "cpu"))
        table = torch.from_numpy(TABLE)
    else:
        cache = init_cache_batch(model.spec, B, "cpu")
    for i in range(STEPS):
        toks = torch.from_numpy(TOKENS[i])
        pos = torch.from_numpy(_clock(kind, i))
        if kind.startswith("paged"):
            got = model.forward_batch_paged(cache, toks, pos, table)
        else:
            got = model.forward_batch(cache, toks, pos)
        out.append(got.numpy())
    return np.stack(out)


def _streams(group, tokenizer_path):
    """generate_batch's rows and the continuous engine's, greedy."""
    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine
    from distributed_llama_tpu_torch.parallel.tp import shard_params
    from distributed_llama_tpu_torch.runtime.generate import generate_batch

    tok = Tokenizer(tokenizer_path, SPEC.vocab_size)
    params = _port_tree()
    if group is not None:
        params = shard_params(params, group.rank, group.size, "fused")
    kw = {} if group is None else dict(group=group, scheme="fused")
    rows, _ = generate_batch(SPEC, params, tok, PROMPTS, 12, 0.0, 0.9,
                             1, device="cpu", quiet=True, **kw)
    kw = {} if group is None else dict(mesh=group, scheme="fused")
    eng = ContinuousEngine(SPEC, params, 2, 0.0, 0.9, 1,
                           prefill_chunk=3, page_size=PS, kv_pages=12,
                           device="cpu", **kw)
    reqs = [tok.encode(p, bos=True, eos=False) for p in PROMPTS]
    outs, stats = eng.run(reqs, 14)
    return rows, outs, stats.steps


def _rank_main(rank, world, port, out, tokenizer_path):
    from distributed_llama_tpu_torch.parallel.mesh import close, init_rank
    from distributed_llama_tpu_torch.parallel.tp import (make_sharded_forward,
                                                         shard_params)

    g = init_rank(rank, world, f"tcp://localhost:{port}", "cpu")
    res = {}
    with torch.inference_mode():
        for scheme in SCHEMES:
            bands = shard_params(_port_tree(), rank, world, scheme)
            model = make_sharded_forward(SPEC, bands, g, scheme)
            for kind in KINDS:
                res[(scheme, kind)] = _steps(model, kind)
        res["streams"] = _streams(g, tokenizer_path)
    if rank == 0:
        with open(out, "wb") as fh:
            pickle.dump(res, fh)
    close(g)


@pytest.fixture(scope="module")
def tokenizer_path(tmp_path_factory):
    from distributed_llama_tpu_torch.io.tokenizer import write_tokenizer

    pieces = [b"<unk>", b"<s>", b"</s>"]
    pieces += [f"<0x{i:02X}>".encode() for i in range(64)]
    pieces += [b" ", b"h", b"i", b"hi", b" hi"]
    while len(pieces) < SPEC.vocab_size:
        pieces.append(f"tok{len(pieces)}".encode())
    path = str(tmp_path_factory.mktemp("tok") / "tok.bin")
    write_tokenizer(path, pieces, [0.0] * len(pieces))
    return path


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, tokenizer_path):
    d = tmp_path_factory.mktemp("tpb")
    return spawn_ranks(_rank_main, 2, d / "tp2.pkl", tokenizer_path)


@functools.lru_cache(maxsize=None)
def _tp1(kind):
    from distributed_llama_tpu_torch.models.llama import (Llama,
                                                          params_to_device)

    model = Llama(SPEC, params_to_device(_port_tree(), "cpu"))
    with torch.inference_mode():
        return _steps(model, kind)


@functools.lru_cache(maxsize=None)
def _jax(kind, scheme):
    """The JAX package's sharded batch step at tp=2 over the same inputs."""
    import jax.numpy as jnp

    from distributed_llama_tpu.io.loader import Q40Weight
    from distributed_llama_tpu.models import llama as jl
    from distributed_llama_tpu.models.spec import TransformerSpec as JSpec
    from distributed_llama_tpu.parallel import (
        make_mesh, make_sharded_forward_batch,
        make_sharded_forward_batch_paged, shard_cache_batch,
        shard_cache_paged, shard_params)

    jspec = JSpec(**BASE, weights_float_type=2)
    mesh = make_mesh(tp=2)
    params = shard_params(_tree(SPEC, Q40Weight), mesh, scheme=scheme)
    if kind.startswith("paged"):
        q8 = kind == "paged-q8"
        n_pages = 1 + B * 8
        cache = shard_cache_paged(
            jl.init_cache_paged_q8(jspec, n_pages, PS) if q8
            else jl.init_cache_paged(jspec, n_pages, PS), mesh)
        step = make_sharded_forward_batch_paged(
            jspec, mesh, PS, scheme=scheme, kv_quant="q8" if q8 else "f32")
        extra = (jnp.asarray(TABLE),)
    else:
        cache = shard_cache_batch(jl.init_cache_batch(jspec, B), mesh)
        step = make_sharded_forward_batch(jspec, mesh, scheme=scheme)
        extra = ()
    out = []
    for i in range(STEPS):
        got, cache = step(params, cache, jnp.asarray(TOKENS[i], jnp.int32),
                          jnp.asarray(_clock(kind, i)), *extra)
        out.append(np.asarray(got))
    return np.stack(out)


def _close(got, want, kind):
    atol = (Q8_RTOL * np.abs(want).max() if kind == "paged-q8"
            else F32_ATOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_batch_step_matches_tp1_and_jax(ranks, scheme, kind):
    got = ranks[(scheme, kind)]
    assert got.shape == (STEPS, B, SPEC.vocab_size) and np.isfinite(got).all()
    _close(got, _tp1(kind), kind)
    # the JAX package pins overlap to fused bit for bit
    want = _jax(kind, "fused" if scheme == "overlap" else scheme)
    _close(got, want, kind)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_generate_batch_and_continuous_streams_equal_tp1(ranks,
                                                         tokenizer_path):
    rows, outs, steps = ranks["streams"]
    with torch.inference_mode():
        want_rows, want_outs, want_steps = _streams(None, tokenizer_path)
    assert rows == want_rows and any(len(r) > 3 for r in rows)
    assert outs == want_outs and steps == want_steps
