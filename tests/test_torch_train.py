"""The port's training path (models/llama.forward_seq, parallel/train.py,
io/loader.densify_params) against the JAX package's on the same seeded
numpy inputs, on the CPU at tests/test_train.py's small spec (GQA, 2
layers):

* forward_seq equals JAX's forward_seq (2e-5 abs), with default and
  shifted positions, and the port's own cached forward (3e-5 abs, the
  JAX twin test_forward_seq_matches_cached_forward);
* step 0's loss (rtol 1e-6) and every gradient leaf (1e-6 abs, ~1e-4 of
  the largest gradient) equal ``jax.value_and_grad`` of the JAX loss;
* six steps' losses equal make_train_step's (rtol 1e-6) and the params
  after them agree at rounding (median 1e-6, at most 0.1% of a leaf
  past 1e-5), none past 2 * lr * steps: Adam's first steps are
  ~lr * sign(g), so an element whose gradient sits at rounding noise
  may move the other way in one package (JAX's own sp gate uses 2e-4
  at lr 1e-3);
* one AdamW update equals optax.adamw's on every leaf (1e-7 abs);
* densify_params equals JAX's on the Q40 and F16 values (exactly).
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.models.spec import TransformerSpec

BASE = dict(dim=64, hidden_dim=160, n_layers=2, n_heads=4, n_kv_heads=2,
            vocab_size=96, seq_len=16)
SPEC = TransformerSpec(**BASE)
LR = 3e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for the small CPU forwards (xdist workers with
    full pools ran ~10x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(seed=3, scale=0.1):
    """tests/test_train.py's seeded parameters."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"tok_embedding": t(SPEC.vocab_size, SPEC.dim),
         "rms_final": 1 + t(SPEC.dim), "wcls": t(SPEC.vocab_size, SPEC.dim),
         "rms_att": 1 + t(SPEC.n_layers, SPEC.dim),
         "rms_ffn": 1 + t(SPEC.n_layers, SPEC.dim)}
    for name, shape in SPEC.layer_matmul_shapes():
        p[name] = t(SPEC.n_layers, *shape)
    return p


def _tokens(shape=(4, 9), seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, SPEC.vocab_size, shape).astype(np.int32)


def _jspec():
    from distributed_llama_tpu.models.spec import TransformerSpec as JSpec

    return JSpec(**BASE)


def _torch(p):
    return {k: torch.from_numpy(v.copy()) for k, v in p.items()}


@pytest.mark.parametrize("offset", [0, 5])
def test_forward_seq_matches_jax(offset):
    import jax.numpy as jnp

    from distributed_llama_tpu.models.llama import forward_seq as jfs
    from distributed_llama_tpu_torch.models.llama import forward_seq

    p, tok = _params(), _tokens((3, 9), seed=offset)
    pos = np.arange(9) + offset
    want = np.asarray(jfs(_jspec(), {k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(tok), positions=jnp.asarray(pos)))
    got = forward_seq(SPEC, _torch(p), torch.from_numpy(tok).long(),
                      positions=torch.from_numpy(pos))
    assert got.shape == (3, 9, SPEC.vocab_size)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=2e-5)


def test_forward_seq_matches_cached_forward():
    from distributed_llama_tpu_torch.models.llama import (PLAIN, Llama,
                                                          forward_seq,
                                                          init_cache,
                                                          params_to_device)

    p = _params()
    tokens = np.array([[1, 5, 9, 2, 17]], dtype=np.int64)
    lg_seq = forward_seq(SPEC, _torch(p), torch.from_numpy(tokens))
    model = Llama(SPEC, params_to_device(p, "cpu"), route=PLAIN)
    with torch.inference_mode():
        lg_cache = model(init_cache(SPEC, "cpu"), tokens[0].tolist(), 0)
    np.testing.assert_allclose(lg_seq[0].detach().numpy(), lg_cache.numpy(),
                               rtol=0, atol=3e-5)


def test_step0_loss_and_gradients_match_jax():
    import jax
    import jax.numpy as jnp
    import optax

    from distributed_llama_tpu.models.llama import forward_seq as jfs
    from distributed_llama_tpu_torch.parallel.train import loss_and_grads

    p, tok = _params(), _tokens()
    jspec = _jspec()

    def loss_fn(params, tokens):
        logits = jfs(jspec, params, tokens[:, :-1])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, tokens[:, 1:]).mean()

    want_loss, want_g = jax.value_and_grad(loss_fn)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(tok))
    t = torch.from_numpy(tok).long()
    params = {k: v.requires_grad_(True) for k, v in _torch(p).items()}
    loss, grads = loss_and_grads(SPEC, params, t[:, :-1], t[:, 1:],
                                 t[:, 1:].numel())
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert sorted(grads) == sorted(want_g)
    for k in sorted(grads):
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(want_g[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def _jax_run(steps, tok, lr=LR, dp=1, tp=1):
    """make_train_step's losses and final params on the same tokens."""
    import jax.numpy as jnp

    from distributed_llama_tpu.parallel import make_mesh
    from distributed_llama_tpu.parallel.train import make_train_step

    init_fn, step_fn = make_train_step(_jspec(), make_mesh(dp=dp, tp=tp),
                                       learning_rate=lr)
    p, o = init_fn(_params())
    losses = []
    for _ in range(steps):
        p, o, loss = step_fn(p, o, jnp.asarray(tok))
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in p.items()}


def test_six_steps_match_make_train_step():
    from distributed_llama_tpu_torch.parallel.train import make_train_step

    tok = _tokens()
    want_losses, want_p = _jax_run(6, tok)
    init_fn, step_fn = make_train_step(SPEC, learning_rate=LR, device="cpu")
    p, o = init_fn(_params())
    losses = []
    for _ in range(6):
        p, o, loss = step_fn(p, o, tok)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)
    assert o.count == 6
    for k, v in want_p.items():
        diff = np.abs(p[k].detach().numpy() - v)
        assert diff.max() <= 2 * LR * 6, (k, diff.max())
        assert np.median(diff) <= 1e-6, (k, np.median(diff))
        assert (diff > 1e-5).mean() <= 1e-3, (k, (diff > 1e-5).sum())


def test_adamw_update_matches_optax():
    import jax.numpy as jnp
    import optax

    from distributed_llama_tpu_torch.parallel.train import (adamw_init,
                                                            adamw_update)

    rng = np.random.default_rng(7)
    p = {k: v for k, v in _params().items() if k in ("wq", "rms_att")}
    grads = [{k: (rng.standard_normal(v.shape) * 0.01).astype(np.float32)
              for k, v in p.items()} for _ in range(3)]
    opt = optax.adamw(LR)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ts = adamw_init(tp)
    for g in grads:
        u, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        ts = adamw_update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                          ts, LR)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=1e-7, err_msg=k)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js[0].mu[k]),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js[0].nu[k]),
                                   rtol=1e-6, atol=1e-14)
    assert ts.count == int(js[0].count) == 3


@pytest.mark.parametrize("wft", ["q40", "f16"])
def test_densify_params_matches_jax(wft):
    import dataclasses

    from distributed_llama_tpu.io import loader as jloader
    from distributed_llama_tpu.ops.quants import FloatType as JFT
    from distributed_llama_tpu_torch.io import loader
    from distributed_llama_tpu_torch.ops.quants import FloatType

    import tempfile

    ft = {"q40": (JFT.Q40, FloatType.Q40), "f16": (JFT.F16, FloatType.F16)}
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/m.bin"
        jspec = dataclasses.replace(_jspec(), weights_float_type=ft[wft][0])
        jloader.write_model(path, jspec, _params())
        _, jp = jloader.load_model(path, weights_float_type=ft[wft][0])
        _, pp = loader.load_model(path, weights_float_type=ft[wft][1])
        want = jloader.densify_params(jp)
        got = loader.densify_params(pp)
    assert sorted(got) == sorted(want) and "wqkv" not in got
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
