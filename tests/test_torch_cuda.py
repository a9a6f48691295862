"""The port's CUDA kernels against their plain versions on the card, at the
small and ragged shapes that chip_smoke.py's 7B shapes do not reach: row
counts off the kernel's 8-row block, block counts off its 4 x 32 unroll, an
input width whose staged x needs more than 48 KB of shared memory (70B's
w2), head sizes below 128, and every kv_mul the attention kernel is built
for. Every test takes the ``gen`` fixture, which skips it without a GPU;
on one, run

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax, which this file and
the port do not need).
"""

import pytest
import torch

from distributed_llama_tpu_torch.io.loader import Q40Weight
from distributed_llama_tpu_torch.models import llama
from distributed_llama_tpu_torch.models.spec import TransformerSpec
from distributed_llama_tpu_torch.models.synth import synth_params
from distributed_llama_tpu_torch.ops import attention, q40
from distributed_llama_tpu_torch.ops.quants import FloatType


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("d,n", [(1, 32), (7, 64), (9, 4096),
                                 (33, 32 * 129), (64, 11008), (5, 28672)])
def test_q40_kernel_matches_plain(gen, d, n):
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((1, n), device="cuda", generator=gen)
    before = q40.KERNEL.launches
    got = q40.q40_matmul(w, x)
    torch.cuda.synchronize()
    assert q40.KERNEL.launches == before + 1
    want = q40.q40_matmul_plain(w, x)
    assert got.shape == want.shape == (1, d)
    err = (got - want).abs().max().item()
    assert err <= q40.KERNEL_RTOL * want.abs().max().item(), err


def test_q40_kernel_raises_instead_of_falling_back(gen):
    w = q40.random_q40(16, 64, "cuda", gen)
    with pytest.raises(NotImplementedError, match="T=1"):
        q40.q40_matmul(w, torch.randn((2, 64), device="cuda", generator=gen))
    raw = torch.zeros(16 * 2 * 16 + 1, dtype=torch.uint8, device="cuda")
    shifted = Q40Weight(raw[1:].view(16, 2, 16), w.d16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        q40.q40_matmul(shifted, torch.randn((1, 64), device="cuda"))
    with pytest.raises(ValueError, match="on cpu"):
        q40.q40_matmul(Q40Weight(w.qs.cpu(), w.d16),
                       torch.randn((1, 64), device="cuda"))


@pytest.mark.parametrize("kv_mul", [1, 2, 4, 8])
@pytest.mark.parametrize("hs", [64, 128])
@pytest.mark.parametrize("pos", [0, 5, 39])
def test_attention_kernel_matches_plain(gen, kv_mul, hs, pos):
    shape = (2, 40, 2, hs)  # (L, S, n_kv, hs)
    k_all = torch.randn(shape, device="cuda", generator=gen)
    v_all = torch.randn(shape, device="cuda", generator=gen)
    q = torch.randn((2 * kv_mul, hs), device="cuda", generator=gen)
    before = attention.KERNEL.launches
    got = attention.decode_attention(q, k_all, v_all, 1, pos, kv_mul)
    torch.cuda.synchronize()
    assert attention.KERNEL.launches == before + 1
    want = attention.decode_attention_plain(q, k_all, v_all, 1, pos, kv_mul)
    assert got.shape == want.shape == (1, 2 * kv_mul * hs)
    assert (got - want).abs().max().item() <= attention.KERNEL_ATOL
    # a stale suffix past pos stays invisible
    k_all[1, pos + 1:] = 1e6
    v_all[1, pos + 1:] = -1e6
    again = attention.decode_attention(q, k_all, v_all, 1, pos, kv_mul)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_forward_kernels_match_plain_and_count_launches(gen):
    spec = TransformerSpec(dim=256, hidden_dim=704, n_layers=3, n_heads=4,
                           n_kv_heads=2, vocab_size=300, seq_len=16,
                           weights_float_type=FloatType.Q40)
    params = llama.params_to_device(synth_params(spec, q40=True, seed=5),
                                    "cuda")
    kern = llama.Llama(spec, params)
    plain = llama.Llama(spec, params, llama.PLAIN)
    ck, cp = llama.init_cache(spec, "cuda"), llama.init_cache(spec, "cuda")
    with torch.inference_mode():
        for pos, tok in enumerate([1, 40, 7, 299, 3]):
            k0, a0 = q40.KERNEL.launches, attention.KERNEL.launches
            a = kern(ck, tok, pos)
            assert q40.KERNEL.launches - k0 == 4 * spec.n_layers + 1
            assert attention.KERNEL.launches - a0 == spec.n_layers
            b = plain(cp, tok, pos)
            assert torch.isfinite(a).all()
            err = (a - b).abs().max().item()
            assert err <= llama.LOGIT_RTOL * b.abs().max().item(), (pos, err)
