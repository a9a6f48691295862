"""Ring attention and data/tensor/sequence-parallel training of the port
over gloo ranks on the CPU (parallel/ring.ring_attention, parallel/
sp_train.py, parallel/train.py under a dp x tp group), against the JAX
package on the same seeded numpy inputs:

* ring_attention over sp 2 and sp 4 equals JAX's dense attention_core
  within 2e-5 abs (tests/test_sequence_parallel.py's gate), and the
  gradients of q, k and v (the vjp of a seeded cotangent, flowing back
  through the hops) equal jax.vjp's within 2e-5; one hop a layer step
  (K and V together), S - 1 forward and S - 1 backward;
* the sp step at dp 2 x sp 2 gives JAX make_train_step's dense loss
  (rtol 1e-5) and its wq, w1 and tok_embedding after the step (2e-4, as
  tests/test_sp_train.py), its census train_collective_budget's;
* the dp 2 x tp 2 step gives the single-device step's losses (rtol 1e-6)
  with the budget's collectives, and its state, saved by rank 0 from the
  gathered bands, resumes on one device, continuing the unsplit run.
"""

import pickle

import numpy as np
import pytest
import torch
from test_torch_tp import spawn_ranks

from distributed_llama_tpu_torch.models.spec import TransformerSpec

ATOL = 2e-5
HS, N_Q, N_KV, T, B = 8, 4, 2, 32, 2
SP_BASE = dict(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
               vocab_size=128, seq_len=64)
TP_BASE = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=4, n_kv_heads=2,
               vocab_size=96, seq_len=16)
LR = 1e-3


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, N_Q, HS)).astype(np.float32)
    k = rng.standard_normal((B, T, N_KV, HS)).astype(np.float32)
    v = rng.standard_normal((B, T, N_KV, HS)).astype(np.float32)
    cot = rng.standard_normal((B, T, N_Q * HS)).astype(np.float32)
    return q, k, v, cot


def _ring_rank(rank, world, port, out, dp):
    """One rank of dp x sp (sp = world / dp): ring attention over its sp
    group on its chunk, forward and vjp; then (dp > 1) the sp step."""
    from distributed_llama_tpu_torch.parallel import collectives as C
    from distributed_llama_tpu_torch.parallel.mesh import close, init_mesh
    from distributed_llama_tpu_torch.parallel.ring import ring_attention

    sp = world // dp
    g = init_mesh(rank, sp, 1, f"tcp://localhost:{port}", "cpu", dp=dp)
    chunk = T // sp
    cols = slice(g.sp_rank * chunk, (g.sp_rank + 1) * chunk)
    q, k, v, cot = (torch.from_numpy(a[:, cols].copy()) for a in _qkv())
    for t in (q, k, v):
        t.requires_grad_(True)
    C.CENSUS.reset()
    o = ring_attention(HS, N_Q // N_KV, q, k, v, g.sp_rank * chunk, chunk, g)
    (o * cot).sum().backward()
    res = {"out": o.detach().numpy(), "grads": [t.grad.numpy()
                                                for t in (q, k, v)],
           "census": dict(C.CENSUS.counts)}
    if dp > 1:
        with open(out + ".in", "rb") as fh:
            params, tokens = pickle.load(fh)
        from distributed_llama_tpu_torch.parallel.sp_train import \
            make_sp_train_step

        init_fn, step_fn = make_sp_train_step(TransformerSpec(**SP_BASE), g,
                                              learning_rate=LR)
        p, o = init_fn(params)
        C.CENSUS.reset()
        p, o, loss = step_fn(p, o, tokens)
        res["step"] = dict(loss=float(loss), census=dict(C.CENSUS.counts),
                           params={n: p[n].detach().numpy()
                                   for n in ("wq", "w1", "tok_embedding")})
    with open(f"{out}.{rank}", "wb") as fh:
        pickle.dump(res, fh)
    if rank == 0:
        with open(out, "wb") as fh:
            pickle.dump(None, fh)
    close(g)


def _jax_dense(q, k, v, cot):
    import jax
    import jax.numpy as jnp

    from distributed_llama_tpu.models.llama import attention_core

    mask = jnp.asarray(np.tril(np.ones((T, T), bool)))

    def f(q, k, v):
        return attention_core(HS, N_Q // N_KV, q, k, v, mask)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _sp_inputs():
    from distributed_llama_tpu.models.spec import TransformerSpec as JSpec
    from distributed_llama_tpu.models.synth import synth_params

    params = synth_params(JSpec(**SP_BASE), q40=False, seed=8, scale=0.15)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, SP_BASE["vocab_size"], (4, 17)).astype(np.int32)
    return {k: np.asarray(v) for k, v in params.items()}, tokens


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    d = tmp_path_factory.mktemp("ring")
    out = {}
    for world, dp in ((2, 1), (4, 2)):
        path = d / f"ring{world}.pkl"
        if dp > 1:
            with open(str(path) + ".in", "wb") as fh:
                pickle.dump(_sp_inputs(), fh)
        spawn_ranks(_ring_rank, world, path, dp)
        got = []
        for r in range(world):
            with open(f"{path}.{r}", "rb") as fh:
                got.append(pickle.load(fh))
        out[(world, dp)] = got
    return out


@pytest.mark.parametrize("world,dp", [(2, 1), (4, 2)])
def test_ring_attention_matches_dense_forward_and_gradients(rings, world,
                                                            dp):
    want, want_g = _jax_dense(*_qkv())
    got = rings[(world, dp)]
    sp = world // dp
    # the ranks of dp index 0 hold the sp chunks in order
    out = np.concatenate([got[s]["out"] for s in range(sp)], axis=1)
    np.testing.assert_allclose(out, want, rtol=0, atol=ATOL)
    for i, name in enumerate("qkv"):
        grad = np.concatenate([got[s]["grads"][i] for s in range(sp)],
                              axis=1)
        np.testing.assert_allclose(grad, want_g[i], rtol=0, atol=ATOL,
                                   err_msg=name)
    hop = 2 * B * T // sp * N_KV * HS * 4  # K and V of a chunk, f32
    for r in got:
        assert r["census"] == {"ppermute": [2 * (sp - 1), 2 * (sp - 1) * hop]}


def test_ring_attention_sp4_matches_dense(tmp_path):
    path = tmp_path / "ring4.pkl"
    spawn_ranks(_ring_rank, 4, path, 1)
    got = []
    for r in range(4):
        with open(f"{path}.{r}", "rb") as fh:
            got.append(pickle.load(fh))
    want, want_g = _jax_dense(*_qkv())
    np.testing.assert_allclose(np.concatenate([g["out"] for g in got], 1),
                               want, rtol=0, atol=ATOL)
    for i in range(3):
        np.testing.assert_allclose(
            np.concatenate([g["grads"][i] for g in got], 1), want_g[i],
            rtol=0, atol=ATOL)
    assert all(g["census"]["ppermute"][0] == 6 for g in got)


def test_sp_step_matches_the_dense_step(rings):
    import jax.numpy as jnp

    from distributed_llama_tpu.models.spec import TransformerSpec as JSpec
    from distributed_llama_tpu.parallel import make_mesh
    from distributed_llama_tpu.parallel.train import make_train_step
    from distributed_llama_tpu_torch.parallel.train import \
        train_collective_budget

    params, tokens = _sp_inputs()
    init_fn, step_fn = make_train_step(JSpec(**SP_BASE), make_mesh(dp=2),
                                       learning_rate=LR)
    p, o = init_fn(params)
    p, o, loss = step_fn(p, o, jnp.asarray(tokens))
    budget = train_collective_budget(TransformerSpec(**SP_BASE), dp=2, sp=2)
    for r in rings[(4, 2)]:
        step = r["step"]
        np.testing.assert_allclose(step["loss"], float(loss), rtol=1e-5,
                                   atol=1e-5)
        for k, v in step["params"].items():
            np.testing.assert_allclose(v, np.asarray(p[k]), rtol=2e-4,
                                       atol=2e-4, err_msg=k)
        assert {k: c for k, (c, _) in step["census"].items()} == budget


def _tp_rank(rank, world, port, out, ck):
    """dp 2 x tp 2: two steps with the census, then the state saved."""
    from distributed_llama_tpu_torch.parallel import collectives as C
    from distributed_llama_tpu_torch.parallel.mesh import close, init_mesh
    from distributed_llama_tpu_torch.parallel.train import (
        make_train_step, save_train_state)

    g = init_mesh(rank, 1, 2, f"tcp://localhost:{port}", "cpu", dp=2)
    spec = TransformerSpec(**TP_BASE)
    from test_torch_train import _params, _tokens

    init_fn, step_fn = make_train_step(spec, g, learning_rate=LR)
    p, o = init_fn(_params())
    losses, census = [], []
    for _ in range(2):
        C.CENSUS.reset()
        p, o, loss = step_fn(p, o, _tokens())
        losses.append(float(loss))
        census.append({k: c for k, (c, _) in C.CENSUS.counts.items()})
    save_train_state(ck, spec, p, o, step=2, data_seed=0, group=g)
    if rank == 0:
        with open(out, "wb") as fh:
            pickle.dump({"losses": losses, "census": census}, fh)
    close(g)


def test_dp2_tp2_step_matches_one_device_and_resumes_there(tmp_path):
    from test_torch_train import _params, _tokens

    from distributed_llama_tpu_torch.parallel.train import (
        load_train_state, make_train_step, template_params,
        train_collective_budget)

    ck = str(tmp_path / "dp2tp2.npz")
    got = spawn_ranks(_tp_rank, 4, tmp_path / "tp.pkl", ck)
    spec = TransformerSpec(**TP_BASE)
    init_fn, step_fn = make_train_step(spec, learning_rate=LR, device="cpu")
    p, o = init_fn(_params())
    want = []
    for _ in range(4):
        p, o, loss = step_fn(p, o, _tokens())
        want.append(float(loss))
    np.testing.assert_allclose(got["losses"], want[:2], rtol=1e-6)
    budget = train_collective_budget(spec, tp=2, dp=2)
    assert budget == {"all_gather": 15, "psum": 15, "dp_psum": 1}
    assert got["census"] == [budget, budget]
    p, o = init_fn(template_params(spec))
    p, o, step = load_train_state(ck, spec, p, o, return_step=True)
    assert step == 2 and o.count == 2
    resumed = []
    for _ in range(2):
        p, o, loss = step_fn(p, o, _tokens())
        resumed.append(float(loss))
    np.testing.assert_allclose(resumed, want[2:], rtol=1e-6)
