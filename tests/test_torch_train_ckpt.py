"""Training checkpoints across the two packages (parallel/train.py's
save_train_state / load_train_state / read_train_meta against the JAX
package's), on the CPU at tests/test_train.py's small spec:

* the port writes the JAX file: the same keys, leaf shapes and dtypes in
  the JAX pytree order (params, count, mu, nu), values equal at rounding;
* a JAX-saved state resumes in the port and a port-saved state resumes
  in the JAX package, each continuing the JAX unsplit run's losses (rtol
  1e-5: two steps in the other package);
* within the port, a 2 + 2 split equals the unsplit 4 steps (losses rtol
  1e-6, the JAX gate; params equal);
* the refusals (version, header, leaf count, leaf shape, leaf dtype)
  raise the JAX package's ValueError messages, word for word.
"""


import numpy as np
import pytest
import torch

from test_torch_train import (BASE, LR, SPEC, _jspec, _one_thread,  # noqa
                              _params, _tokens)


def _jax_steps(init_from, steps, tok, ck_out=None, ck_in=None):
    """The JAX step on a dp 2 x tp 2 mesh: ``steps`` steps from fresh
    params or from ``ck_in``; saves to ``ck_out``. Returns the losses."""
    import jax.numpy as jnp

    from distributed_llama_tpu.parallel import make_mesh
    from distributed_llama_tpu.parallel.train import (load_train_state,
                                                      make_train_step,
                                                      save_train_state)

    jspec = _jspec()
    init_fn, step_fn = make_train_step(jspec, make_mesh(dp=2, tp=2),
                                       learning_rate=LR)
    p, o = init_fn(init_from)
    if ck_in:
        p, o = load_train_state(ck_in, jspec, p, o)
    losses = []
    for _ in range(steps):
        p, o, loss = step_fn(p, o, jnp.asarray(tok))
        losses.append(float(loss))
    if ck_out:
        save_train_state(ck_out, jspec, p, o, step=steps, data_seed=3)
    return losses


def _port_steps(steps, tok, ck_out=None, ck_in=None):
    from distributed_llama_tpu_torch.parallel.train import (
        load_train_state, make_train_step, save_train_state,
        template_params)

    init_fn, step_fn = make_train_step(SPEC, learning_rate=LR, device="cpu")
    if ck_in:
        p, o = init_fn(template_params(SPEC))
        p, o = load_train_state(ck_in, SPEC, p, o)
    else:
        p, o = init_fn(_params())
    losses = []
    for _ in range(steps):
        p, o, loss = step_fn(p, o, tok)
        losses.append(float(loss))
    if ck_out:
        save_train_state(ck_out, SPEC, p, o, step=steps, data_seed=3)
    return losses, p, o


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ck")
    tok = _tokens()
    out = {"tok": tok, "dir": d}
    out["jax_full"] = _jax_steps(_params(), 4, tok)
    out["jax_ck"] = str(d / "jax.npz")
    _jax_steps(_params(), 2, tok, ck_out=out["jax_ck"])
    out["port_ck"] = str(d / "port.npz")
    out["port_full"] = _port_steps(4, tok)
    _port_steps(2, tok, ck_out=out["port_ck"])
    return out


def test_port_writes_the_jax_layout(runs):
    with np.load(runs["jax_ck"]) as j, np.load(runs["port_ck"]) as p:
        assert sorted(j.files) == sorted(p.files)
        assert int(p["__n_leaves__"]) == 3 * len(_params()) + 1
        for key in j.files:
            assert j[key].shape == p[key].shape, key
            assert j[key].dtype == p[key].dtype, key
            if key.startswith("leaf_"):
                np.testing.assert_allclose(p[key], j[key], rtol=1e-4,
                                           atol=1e-6, err_msg=key)
            else:
                np.testing.assert_array_equal(p[key], j[key], err_msg=key)


def test_jax_state_resumes_in_the_port(runs):
    from distributed_llama_tpu_torch.parallel.train import read_train_meta

    assert read_train_meta(runs["jax_ck"]) == {"step": 2, "data_seed": 3}
    losses, _, o = _port_steps(2, runs["tok"], ck_in=runs["jax_ck"])
    assert o.count == 4
    np.testing.assert_allclose(losses, runs["jax_full"][2:], rtol=1e-5)


def test_port_state_resumes_in_jax(runs):
    losses = _jax_steps(_params(), 2, runs["tok"], ck_in=runs["port_ck"])
    np.testing.assert_allclose(losses, runs["jax_full"][2:], rtol=1e-5)


def test_port_split_equals_unsplit(runs):
    full_losses, full_p, _ = runs["port_full"]
    part, p, _ = _port_steps(2, runs["tok"], ck_in=runs["port_ck"])
    first, _, _ = _port_steps(2, runs["tok"])
    np.testing.assert_allclose(first + part, full_losses, rtol=1e-6)
    for k in full_p:
        np.testing.assert_allclose(p[k].detach().numpy(),
                                   full_p[k].detach().numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def _refusal(load, *args):
    with pytest.raises(ValueError) as e:
        load(*args)
    return str(e.value)


def test_refusals_carry_the_jax_messages(runs, tmp_path):
    import jax.numpy as jnp

    from distributed_llama_tpu.models.spec import TransformerSpec as JSpec
    from distributed_llama_tpu.parallel import make_mesh
    from distributed_llama_tpu.parallel import train as jtrain
    from distributed_llama_tpu_torch.models.spec import TransformerSpec
    from distributed_llama_tpu_torch.parallel import train

    ck = runs["port_ck"]
    jinit, _ = jtrain.make_train_step(_jspec(), make_mesh(dp=1, tp=1),
                                      learning_rate=LR)
    jp, jo = jinit(_params())
    pinit, _ = train.make_train_step(SPEC, learning_rate=LR, device="cpu")
    pp, po = pinit(_params())

    # version
    with np.load(ck) as z:
        files = {k: z[k] for k in z.files}
    files["__version__"] = np.asarray(2)
    bad = str(tmp_path / "v2.npz")
    with open(bad, "wb") as fh:
        np.savez(fh, **files)
    cases = {"version": ((bad, _jspec(), jp, jo), (bad, SPEC, pp, po))}
    # header: another seq_len
    cases["header"] = (
        (ck, JSpec(**dict(BASE, seq_len=64)), jp, jo),
        (ck, TransformerSpec(**dict(BASE, seq_len=64)), pp, po))
    # leaf count: a one-leaf params template
    cases["leaves"] = ((ck, _jspec(), {"only": jp["wq"]}, jo),
                       (ck, SPEC, {"only": pp["wq"]}, po))
    # leaf shape: a params template of another width
    jwide = dict(jp, rms_final=jnp.zeros((SPEC.dim + 2,), jnp.float32))
    pwide = dict(pp, rms_final=torch.zeros(SPEC.dim + 2))
    cases["shape"] = ((ck, _jspec(), jwide, jo), (ck, SPEC, pwide, po))
    # leaf dtype: a bf16 leaf
    jbf = dict(jp, rms_final=jp["rms_final"].astype(jnp.bfloat16))
    pbf = dict(pp, rms_final=pp["rms_final"].detach().to(torch.bfloat16))
    cases["dtype"] = ((ck, _jspec(), jbf, jo), (ck, SPEC, pbf, po))
    for what, (jargs, pargs) in cases.items():
        want = _refusal(jtrain.load_train_state, *jargs)
        got = _refusal(train.load_train_state, *pargs)
        assert got == want, (what, got, want)
        assert what.rstrip("s") in got, got
