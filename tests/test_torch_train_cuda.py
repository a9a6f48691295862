"""The training step on the card against the same step on the CPU
(parallel/train.py on a narrow model: dim 256, 2 layers, GQA): step 0's
loss (rtol 1e-5) and every gradient leaf (1e-5 of the leaf's largest
gradient), then three steps' losses (rtol 1e-5). TF32 stays off, so the
card's f32 products are the CPU's up to the order of the sums. Every test
takes the ``card`` fixture, which skips it without a GPU; on one, run

    python -m pytest --noconftest tests/test_torch_train_cuda.py
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.models.spec import TransformerSpec

SPEC = TransformerSpec(dim=256, hidden_dim=688, n_layers=2, n_heads=8,
                       n_kv_heads=4, vocab_size=512, seq_len=64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _params(seed=1, scale=0.05):
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


def _tokens():
    rng = np.random.default_rng(2)
    return rng.integers(0, SPEC.vocab_size, (4, 33)).astype(np.int32)


def test_train_step_on_the_card_equals_the_cpu_step(card):
    from distributed_llama_tpu_torch.parallel.train import (loss_and_grads,
                                                            make_train_step)

    assert not torch.backends.cuda.matmul.allow_tf32
    tok = torch.from_numpy(_tokens()).long()
    out = {}
    for dev in ("cpu", card):
        init_fn, _ = make_train_step(SPEC, learning_rate=1e-3, device=dev)
        p, _ = init_fn(_params())
        t = tok.to(dev)
        loss, grads = loss_and_grads(SPEC, p, t[:, :-1], t[:, 1:],
                                     t[:, 1:].numel())
        out[str(dev)] = float(loss), {k: g.cpu().numpy()
                                      for k, g in grads.items()}
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)
    for k, g in g_cpu.items():
        np.testing.assert_allclose(g_gpu[k], g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)


def test_three_steps_on_the_card_equal_the_cpu_steps(card):
    from distributed_llama_tpu_torch.parallel.train import make_train_step

    losses = {}
    for dev in ("cpu", card):
        init_fn, step_fn = make_train_step(SPEC, learning_rate=1e-3,
                                           device=dev)
        p, o = init_fn(_params())
        got = []
        for _ in range(3):
            p, o, loss = step_fn(p, o, _tokens())
            got.append(float(loss))
        losses[str(dev)] = got
    assert np.isfinite(losses["cuda"]).all()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
