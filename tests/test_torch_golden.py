"""Golden single-block parity of the port: its ``_layer`` on the reference's
7B-width F32 block, driven as tests/test_golden_forward.py drives the JAX
``_layer`` (weights and x from xorshift seed 800000010 scaled by 1/120, one
block at pos 0), against the reference's hard-coded 4096-float expected
output. Tolerance 1e-5 per element, the reference's own."""

import os

import numpy as np
import pytest
import torch

from distributed_llama_tpu.utils.native import xorshift_fill

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "golden_block_7b_f32.npy")


@pytest.fixture(scope="module")
def golden_setup():
    state = 800000010
    dim, hid = 4096, 11008
    sizes = [("rms_att", (dim,)), ("rms_ffn", (dim,)),
             ("wq", (dim, dim)), ("wk", (dim, dim)), ("wv", (dim, dim)),
             ("wo", (dim, dim)), ("w1", (hid, dim)), ("w2", (dim, hid)),
             ("w3", (hid, dim))]
    lw = {}
    for name, shape in sizes:
        state, arr = xorshift_fill(state, int(np.prod(shape)), 120.0)
        lw[name] = arr.reshape(shape)
    state, x = xorshift_fill(state, dim, 120.0)
    return lw, x, np.load(FIXTURE)


def test_golden_block_forward(golden_setup):
    from distributed_llama_tpu_torch.models.llama import (_layer, init_cache,
                                                          rope_freq,
                                                          rope_tables)
    from distributed_llama_tpu_torch.models.spec import TransformerSpec

    spec = TransformerSpec(dim=4096, hidden_dim=11008, n_layers=1,
                           n_heads=32, n_kv_heads=32, vocab_size=32000,
                           seq_len=2048)
    lw, x, expected = golden_setup
    lwt = {k: torch.from_numpy(v) for k, v in lw.items()}
    cache = init_cache(spec, "cpu")
    rope = rope_tables(rope_freq(spec.dim + spec.kv_dim, spec.head_size,
                                 "cpu"), 0)
    with torch.inference_mode():
        out = _layer(spec, torch.from_numpy(x)[None], lwt, cache, 0, 0,
                     rope)
    got = out[0].numpy()
    err = np.abs(got - expected)
    assert err.max() <= 1e-5, (
        f"max err {err.max():.3e} at {err.argmax()}: "
        f"{got[err.argmax()]!r} != {expected[err.argmax()]!r}")
    # the block wrote its k/v at (layer 0, pos 0) and nowhere else
    assert cache.k[0, 0].abs().sum() > 0
    assert cache.k[0, 1:].abs().sum() == 0
