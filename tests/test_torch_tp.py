"""Tensor parallelism of the port (parallel/tp.TPLlama over gloo ranks on the
CPU) against the port at tp=1 and the JAX package's sharded forward at the
same tp (twins of tests/test_tensor_parallel.py and
tests/test_overlap_scheme.py).

One spawn a world size (2 and 4 ranks) runs every case: the three schemes,
f32 and Q80 buffers, F32 and Q40 weights, on a GQA model (8 query heads
over 4 kv heads). A case prefills 9 tokens in one call (T > 8: the Q40
GEMM route and prefill attention over the rank's bands) and decodes 6
greedy steps (T = 1). Tolerances, on every call's logits:

* f32 buffers: |tp=N - tp=1| and |port - JAX| <= 2e-5 (the JAX tp tests'
  atol): the sums differ only in order (an all_reduce sums in the
  backend's order, so overlap equals fused within this too, where the JAX
  package pins them bit for bit);
* Q80 buffers: |port - JAX| at the same tp <= 1e-2 x max|JAX| (the same
  quantization cut points; where the two f32 sums before a cut differ in
  their last bit, a code can land one Q80 step apart, ~1/127 of its
  block's largest value, and that step travels on: 3.5e-3 of a max of 3.6
  was seen), and |tp=N - tp=1| < 0.15 (the wire quantizes the gathered
  bands as the reference does: rounding compounds, the JAX
  test_tp_q80_buffer_wire_quantization bound).

The greedy streams equal the JAX package's, and the port's tp=1 one (Q80:
apart only at a near-tie of tp=1's logits, within 0.3), and every
decode step's collectives, counted by parallel/collectives.CENSUS, equal
comm_stats.tp_collective_budget in kind, count and bytes (the prefill's
in bytes at t_len 9)."""

import functools
import pickle

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.models.spec import TransformerSpec
from distributed_llama_tpu_torch.ops.quants import FloatType

BASE = dict(dim=128, hidden_dim=256, n_layers=2, n_heads=8, n_kv_heads=4,
            vocab_size=96, seq_len=32)
SCHEMES = ("ref", "fused", "overlap")
CASES = [(scheme, buf, wft) for scheme in SCHEMES for buf in ("f32", "q80")
         for wft in ("f32", "q40")]
PROMPT = list(range(1, 10))
DECODE = 6
F32_ATOL = 2e-5
Q80_RTOL_JAX = 1e-2
Q80_TP1_BOUND = 0.15


def _spec(buf: str, wft: str) -> TransformerSpec:
    return TransformerSpec(
        **BASE, weights_float_type=FloatType.Q40 if wft == "q40"
        else FloatType.F32,
        buffer_float_type=FloatType.Q80 if buf == "q80" else FloatType.F32)


def _dense_tree(spec: TransformerSpec, seed: int = 11) -> dict:
    rng = np.random.default_rng(seed)

    def t(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    p = {"tok_embedding": t(spec.vocab_size, spec.dim),
         "rms_final": 1 + t(spec.dim), "wcls": t(spec.vocab_size, spec.dim),
         "rms_att": 1 + t(spec.n_layers, spec.dim),
         "rms_ffn": 1 + t(spec.n_layers, spec.dim)}
    for name, shape in spec.layer_matmul_shapes():
        p[name] = t(spec.n_layers, *shape)
    return p


def _tree(spec: TransformerSpec, q40_type) -> dict:
    """The seeded tree, matmul weights Q40-coded into ``q40_type`` pairs
    (the port's or the JAX package's Q40Weight) under Q40 weights."""
    from distributed_llama_tpu_torch.ops.quants import quantize_q40

    p = _dense_tree(spec)
    if spec.weights_float_type == FloatType.Q40:
        for name in ("wcls", *dict(spec.layer_matmul_shapes())):
            p[name] = q40_type(*quantize_q40(p[name]))
    return p


def _port_tree(spec):
    from distributed_llama_tpu_torch.io.loader import Q40Weight

    return _tree(spec, Q40Weight)


def _run_case(model, cache):
    """Prefill PROMPT, then DECODE greedy steps: (logits per call, tokens,
    census per call)."""
    from distributed_llama_tpu_torch.parallel import collectives as C

    logits, toks, census = [], [], []
    pos, tokens = 0, PROMPT
    for _ in range(DECODE + 1):
        C.CENSUS.reset()
        out = model(cache, tokens, pos).numpy()
        census.append(dict(C.CENSUS.counts))
        logits.append(out)
        pos += len(out)
        tokens = int(out[-1].argmax())
        toks.append(tokens)
    return logits, toks, census


def _rank_main(rank, world, port, out):
    """One gloo rank: every case, rank 0 writes the results."""
    from distributed_llama_tpu_torch.models.llama import init_cache
    from distributed_llama_tpu_torch.parallel.mesh import close, init_rank
    from distributed_llama_tpu_torch.parallel.tp import (make_sharded_forward,
                                                         shard_params)

    g = init_rank(rank, world, f"tcp://localhost:{port}", "cpu")
    res = {}
    with torch.inference_mode():
        for scheme, buf, wft in CASES:
            spec = _spec(buf, wft)
            bands = shard_params(_port_tree(spec), rank, world, scheme)
            model = make_sharded_forward(spec, bands, g, scheme)
            res[(scheme, buf, wft)] = _run_case(
                model, init_cache(model.spec, "cpu"))
    if rank == 0:
        with open(out, "wb") as fh:
            pickle.dump(res, fh)
    close(g)


def spawn_ranks(fn, world, out, *args):
    """Run ``fn(rank, world, port, out, *args)`` in ``world`` spawned
    processes and return what rank 0 pickled to ``out``."""
    import torch.multiprocessing as mp

    from distributed_llama_tpu_torch.parallel.mesh import free_port

    mp.start_processes(fn, args=(world, free_port(), str(out), *args),
                       nprocs=world, start_method="spawn")
    with open(out, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    return {w: spawn_ranks(_rank_main, w, d / f"tp{w}.pkl") for w in (2, 4)}


@pytest.fixture(scope="module")
def tp1():
    """The port's single-device runs of every (buffer, weights) pair."""
    from distributed_llama_tpu_torch.models.llama import (Llama, init_cache,
                                                          params_to_device)

    out = {}
    with torch.inference_mode():
        for buf in ("f32", "q80"):
            for wft in ("f32", "q40"):
                spec = _spec(buf, wft)
                m = Llama(spec, params_to_device(_port_tree(spec), "cpu"))
                out[(buf, wft)] = m, spec
    return out


def _replay(model, spec, toks):
    """The port's tp=1 logits over the tokens the tp run chose."""
    from distributed_llama_tpu_torch.models.llama import init_cache

    cache = init_cache(spec, "cpu")
    with torch.inference_mode():
        got = [model(cache, PROMPT, 0).numpy()]
        for i, t in enumerate(toks[:-1]):
            got.append(model(cache, t, len(PROMPT) + i).numpy())
    return got


@functools.lru_cache(maxsize=None)
def _jax_logits(buf, wft, scheme, tp, toks):
    """The JAX package's sharded forward at tp over the same tokens."""
    import jax.numpy as jnp

    from distributed_llama_tpu.io.loader import Q40Weight
    from distributed_llama_tpu.models.llama import init_cache
    from distributed_llama_tpu.models.spec import TransformerSpec as JSpec
    from distributed_llama_tpu.parallel import (make_mesh,
                                                make_sharded_forward,
                                                shard_cache, shard_params)

    spec = _spec(buf, wft)
    jspec = JSpec(**BASE, weights_float_type=int(spec.weights_float_type),
                  buffer_float_type=int(spec.buffer_float_type))
    mesh = make_mesh(tp=tp)
    fwd = make_sharded_forward(jspec, mesh, scheme=scheme)
    params = shard_params(_tree(spec, Q40Weight), mesh, scheme=scheme)
    cache = shard_cache(init_cache(jspec), mesh)
    got, cache = fwd(params, cache, jnp.asarray(PROMPT, jnp.int32),
                     jnp.int32(0))
    out = [np.asarray(got)]
    for i, t in enumerate(toks[:-1]):
        got, cache = fwd(params, cache, jnp.asarray([t], jnp.int32),
                         jnp.int32(len(PROMPT) + i))
        out.append(np.asarray(got))
    return out


def _case_id(case):
    return "-".join(case)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tp_matches_tp1_and_jax(ranks, tp1, tp, case):
    scheme, buf, wft = case
    logits, toks, _ = ranks[tp][case]
    model, spec = tp1[(buf, wft)]
    want_tp1 = _replay(model, spec, toks)
    # the JAX package pins overlap to fused bit for bit: one JAX run serves
    # both where their streams agree
    want_jax = _jax_logits(buf, wft, "fused" if scheme == "overlap"
                           else scheme, tp, tuple(toks))
    for got, one, jx in zip(logits, want_tp1, want_jax):
        assert got.shape == (len(got), spec.vocab_size) and \
            np.isfinite(got).all()
        if buf == "f32":
            np.testing.assert_allclose(got, one, rtol=0, atol=F32_ATOL)
            np.testing.assert_allclose(got, jx, rtol=0, atol=F32_ATOL)
        else:
            assert np.abs(got - one).max() < Q80_TP1_BOUND
            np.testing.assert_allclose(
                got, jx, rtol=0, atol=Q80_RTOL_JAX * np.abs(jx).max())
    # greedy streams: the JAX argmax at every step, and the tp=1 one (under
    # Q80 the wire's extra rounding may part them only at a near-tie of
    # tp=1's logits, within twice the bound)
    assert [int(x[-1].argmax()) for x in want_jax] == toks
    for one, tok in zip(want_tp1, toks):
        if buf == "f32":
            assert int(one[-1].argmax()) == tok
        else:
            assert one[-1].max() - one[-1][tok] < 2 * Q80_TP1_BOUND


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tp_collectives_equal_the_budget(ranks, tp, case):
    from distributed_llama_tpu_torch.parallel.comm_stats import \
        tp_collective_budget

    scheme, buf, wft = case
    spec = _spec(buf, wft)
    _, _, census = ranks[tp][case]
    step = tp_collective_budget(spec, tp, scheme)
    for counts in census[1:]:
        assert {k: c for k, (c, _) in counts.items()} == step.kind_counts()
        assert {k: b for k, (_, b) in counts.items()} == \
            step.bytes_by_kind()
    prefill = tp_collective_budget(spec, tp, scheme, t_len=len(PROMPT))
    assert {k: b for k, (_, b) in census[0].items()} == \
        prefill.bytes_by_kind()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("buf", ["f32", "q80"])
def test_overlap_equals_fused(ranks, tp, buf):
    """overlap's ring-order sums against fused's all_reduce: within the f32
    tolerance, the streams equal."""
    for wft in ("f32", "q40"):
        over = ranks[tp][("overlap", buf, wft)]
        fused = ranks[tp][("fused", buf, wft)]
        assert over[1] == fused[1]
        for a, b in zip(over[0], fused[0]):
            np.testing.assert_allclose(a, b, rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("n", [32, 64, 160])
def test_q80_wire_is_the_packed_payload(n):
    """The wire's bytes: uint8, 34 a 32-value block (32 codes, then the f16
    delta), the JAX package's _wire_pack bytes; unpacked they are the Q80
    round trip."""
    import jax.numpy as jnp

    from distributed_llama_tpu.models.spec import TransformerSpec as JSpec
    from distributed_llama_tpu.parallel import tp as jtp
    from distributed_llama_tpu_torch.ops.linear import fake_quant_q80
    from distributed_llama_tpu_torch.parallel import tp

    spec = _spec("q80", "q40")
    jspec = JSpec(**BASE, buffer_float_type=3)
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    wire = tp._wire_pack(spec, torch.from_numpy(x))
    assert wire.dtype == torch.uint8 and wire.shape == (3, n // 32 * 34)
    np.testing.assert_array_equal(
        wire.numpy(), np.asarray(jtp._wire_pack(jspec, jnp.asarray(x))))
    back = tp._wire_unpack(spec, wire)
    assert torch.equal(back, fake_quant_q80(torch.from_numpy(x)))
