"""The port's CUDA kernels against their plain versions on the card, at the
small and ragged shapes that chip_smoke.py's 7B shapes do not reach: row
counts off the kernels' row blocks, block counts off their unrolls, stages
and x slices, odd T, an input width whose staged x needs more than 48 KB
of shared memory (70B's w2), head sizes below 128, and every kv_mul the
attention kernels are built for; then the forward and Engine.prefill
through the kernels, with their launch counts; the same for the bf16
kernels (K3b, K4b) and the bf16-cache builds of K2, K4 and K4b, and the
``--fast-prefill`` Engine over a bf16 cache; then the batched decode
attention (K5, both caches; at B = 1 bit for bit K2) and the small-T
bf16-product Q40 body (K1d), and the on-device loops: a step captured in
a CUDA graph and replayed gives the tokens of the same step run eagerly,
with exact launch counts. Every test takes the ``gen`` fixture, which
skips it without a GPU; on one, run

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports jax, which this file and
the port do not need).
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.io.loader import Q40Weight
from distributed_llama_tpu_torch.models import llama
from distributed_llama_tpu_torch.models.spec import TransformerSpec
from distributed_llama_tpu_torch.models.synth import synth_params
from distributed_llama_tpu_torch.ops import attention, q40
from distributed_llama_tpu_torch.ops.quants import FloatType
from distributed_llama_tpu_torch.runtime.generate import (Engine,
                                                          run_chunked_prefill)


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


@pytest.mark.parametrize("d,n,t", [(1, 32, 2), (7, 64, 3), (9, 4096, 4),
                                   (33, 32 * 129, 5), (100, 4096, 6),
                                   (64, 11008, 8), (5, 28672, 7)])
def test_q40_small_t_kernel_matches_plain(gen, d, n, t):
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((t, n), device="cuda", generator=gen)
    counts = [k.launches for k in q40.KERNELS]
    got = q40.q40_matmul(w, x)
    torch.cuda.synchronize()
    assert [k.launches for k in q40.KERNELS] == [counts[0], counts[1] + 1,
                                                 counts[2], counts[3],
                                                 counts[4]]
    want = q40.q40_matmul_plain(w, x)
    assert got.shape == want.shape == (t, d)
    err = (got - want).abs().max().item()
    assert err <= q40.KERNEL_RTOL * want.abs().max().item(), err


@pytest.mark.parametrize("d,n,t", [(1, 32, 9), (7, 64, 16), (65, 4096, 17),
                                   (64, 96, 33), (33, 32 * 129, 100),
                                   (130, 11008, 128), (3, 64, 300)])
def test_q40_gemm_kernel_matches_plain(gen, d, n, t):
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((t, n), device="cuda", generator=gen)
    counts = [k.launches for k in q40.KERNELS]
    got = q40.q40_matmul(w, x)
    torch.cuda.synchronize()
    assert [k.launches for k in q40.KERNELS] == [counts[0], counts[1],
                                                 counts[2] + 1, counts[3],
                                                 counts[4]]
    want = q40.q40_matmul_plain(w, x)
    assert got.shape == want.shape == (t, d)
    err = (got - want).abs().max().item()
    assert err <= q40.KERNEL_RTOL * want.abs().max().item(), err


@pytest.mark.parametrize("d,n", [(33, 32 * 129), (8, 64)])
def test_q40_gemm_reads_scales_at_an_odd_offset(gen, d, n):
    """K3 copies the f16 scales as aligned 32-bit words: scales that start
    in the second half of one (a layer view of a stacked weight can), with
    an odd count, so the last word is half past the end."""
    w = q40.random_q40(d, n, "cuda", gen)
    raw = torch.empty(w.d16.numel() + 1, dtype=torch.float16, device="cuda")
    raw[1:] = w.d16.reshape(-1)
    odd = Q40Weight(w.qs, raw[1:].view(w.d16.shape))
    x = torch.randn((40, n), device="cuda", generator=gen)
    got = q40.q40_matmul(odd, x)
    want = q40.q40_matmul_plain(w, x)
    err = (got - want).abs().max().item()
    assert err <= q40.KERNEL_RTOL * want.abs().max().item(), err


def test_q40_kernel_raises_instead_of_falling_back(gen):
    w = q40.random_q40(16, 64, "cuda", gen)
    for t in (1, 2, 9):  # K1, K1m and K3 check alike
        x = torch.randn((t * 64 + 1,), device="cuda", generator=gen)
        with pytest.raises(ValueError, match="x must be 16-byte aligned"):
            q40.q40_matmul(w, x[1:].view(t, 64))
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


@pytest.mark.parametrize("kv_mul", [1, 2, 4, 8])
@pytest.mark.parametrize("hs", [64, 128])
@pytest.mark.parametrize("pos,t_len", [(0, 2), (5, 33), (40, 70)])
def test_prefill_attention_kernel_matches_plain(gen, kv_mul, hs, pos, t_len):
    shape = (2, 120, 2, hs)  # (L, S, n_kv, hs)
    k_all = torch.randn(shape, device="cuda", generator=gen)
    v_all = torch.randn(shape, device="cuda", generator=gen)
    q = torch.randn((t_len, 2 * kv_mul, hs), device="cuda", generator=gen)
    before = attention.PREFILL_KERNEL.launches
    got = attention.prefill_attention(q, k_all, v_all, 1, pos, kv_mul)
    torch.cuda.synchronize()
    assert attention.PREFILL_KERNEL.launches == before + 1
    want = attention.prefill_attention_plain(q, k_all, v_all, 1, pos, kv_mul)
    assert got.shape == want.shape == (t_len, 2 * kv_mul * hs)
    assert (got - want).abs().max().item() <= attention.KERNEL_ATOL
    # a poisoned suffix past pos + T - 1 stays unread
    k_all[1, pos + t_len:] = 1e9
    v_all[1, pos + t_len:] = float("nan")
    again = attention.prefill_attention(q, k_all, v_all, 1, pos, kv_mul)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_prefill_attention_kernel_raises_instead_of_falling_back(gen):
    k_all = torch.randn((1, 16, 2, 64), device="cuda", generator=gen)
    q = torch.randn((4, 2, 64), device="cuda", generator=gen)
    with pytest.raises(ValueError, match="contiguous"):
        attention.prefill_attention(q.transpose(0, 1).contiguous()
                                    .transpose(0, 1), k_all, k_all, 0, 0, 1)
    with pytest.raises(ValueError, match="on cuda"):
        attention.prefill_attention(q, k_all.cpu(), k_all.cpu(), 0, 0, 1)
    with pytest.raises(ValueError, match="outside the cache"):
        attention.prefill_attention(q, k_all, k_all, 0, 13, 1)


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
        # chunks of T = 4 and 7 (positions 5..15): every matmul, wcls too,
        # through K1m and the attention through K4
        for pos, toks in ((5, [3, 4, 5, 6]), (9, [9, 8, 7, 6, 5, 4, 3])):
            counts = [k.launches for k in (*q40.KERNELS, *attention.KERNELS)]
            a = kern(ck, toks, pos)
            got = [k.launches for k in (*q40.KERNELS, *attention.KERNELS)]
            assert [g - c for g, c in zip(got, counts)] == [
                0, 4 * spec.n_layers + 1, 0, 0, 0,
                0, 0, spec.n_layers, 0, 0, 0, 0, 0]
            b = plain(cp, toks, pos)
            err = (a - b).abs().max().item()
            assert err <= llama.LOGIT_RTOL * b.abs().max().item(), (pos, err)
    torch.testing.assert_close(ck.k, cp.k, rtol=1e-4, atol=1e-5)


def test_engine_prefill_through_the_gemm_counts_launches(gen):
    """Engine.prefill at chunk 16 over 40 tokens: two full windows and one
    padded, each 4L K3 launches and L K4 launches, no logits; the cache
    rows and next-step logits match the plain route on the card."""
    spec = TransformerSpec(dim=256, hidden_dim=704, n_layers=2, n_heads=2,
                           n_kv_heads=2, vocab_size=300, seq_len=64,
                           weights_float_type=FloatType.Q40)
    kern = Engine(spec, synth_params(spec, q40=True, seed=6), "cuda")
    plain = llama.Llama(spec, kern.params, llama.PLAIN)
    cp = llama.init_cache(spec, "cuda")
    tokens = [int(t) for t in torch.randint(2, 300, (40,), generator=torch
                                            .Generator().manual_seed(1))]
    counts = [k.launches for k in (*q40.KERNELS, *attention.KERNELS)]
    kern.prefill(tokens, 0, 16)
    got = [k.launches for k in (*q40.KERNELS, *attention.KERNELS)]
    assert [g - c for g, c in zip(got, counts)] == [
        0, 0, 3 * 4 * spec.n_layers, 0, 0,
        0, 0, 3 * spec.n_layers, 0, 0, 0, 0, 0]
    with torch.inference_mode():
        run_chunked_prefill(
            lambda part, start: plain(cp, part, start, logits=False),
            tokens, 0, 16, spec.seq_len)
        b = plain(cp, 7, 40)[0].cpu().numpy()
    torch.testing.assert_close(kern.cache.k[:, :40], cp.k[:, :40],
                               rtol=1e-4, atol=1e-5)
    a = kern.infer(7, 40)
    assert abs(a - b).max() <= llama.LOGIT_RTOL * abs(b).max()


# ---------------------------------------------------------------------------
# bf16: K3b, K4b and the bf16-cache builds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,n,t", [(1, 32, 9), (7, 64, 16), (65, 4096, 17),
                                   (64, 96, 33), (33, 32 * 129, 100),
                                   (130, 11008, 128), (3, 64, 300)])
def test_q40_gemm_bf16_kernel_matches_plain(gen, d, n, t):
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((t, n), device="cuda", generator=gen)
    counts = [k.launches for k in q40.KERNELS]
    got = q40.q40_matmul(w, x, bf16=True)
    torch.cuda.synchronize()
    assert [k.launches for k in q40.KERNELS] == [*counts[:3], counts[3] + 1,
                                                 counts[4]]
    want = q40.q40_matmul_bf16_plain(w, x)
    assert got.shape == want.shape == (t, d)
    err = (got - want).abs().max().item()
    assert err <= q40.KERNEL_RTOL_BF16 * want.abs().max().item(), err


def test_q40_gemm_bf16_reads_scales_at_an_odd_offset(gen):
    """The f16 scales of a layer view may start at any 2-byte offset."""
    w = q40.random_q40(33, 32 * 129, "cuda", gen)
    raw = torch.empty(w.d16.numel() + 1, dtype=torch.float16, device="cuda")
    raw[1:] = w.d16.reshape(-1)
    odd = Q40Weight(w.qs, raw[1:].view(w.d16.shape))
    x = torch.randn((40, 32 * 129), device="cuda", generator=gen)
    got = q40.q40_matmul(odd, x, bf16=True)
    want = q40.q40_matmul_bf16_plain(w, x)
    err = (got - want).abs().max().item()
    assert err <= q40.KERNEL_RTOL_BF16 * want.abs().max().item(), err


@pytest.mark.parametrize("t", [1, 5, 8])
def test_q40_bf16_flag_at_small_t_takes_the_f32_kernels(gen, t):
    """T <= 8 under bf16 launches K1 / K1m, as the JAX package's T=1 and
    small-T bodies ignore the flag: bitwise the parity result."""
    w = q40.random_q40(40, 256, "cuda", gen)
    x = torch.randn((t, 256), device="cuda", generator=gen)
    counts = [k.launches for k in q40.KERNELS]
    got = q40.q40_matmul(w, x, bf16=True)
    assert q40.KERNEL_GEMM_BF16.launches == counts[3]
    assert q40.KERNEL_MULTI_BF16.launches == counts[4]  # not K1d either
    assert torch.equal(got, q40.q40_matmul(w, x))


def _bf16_caches(gen, shape):
    k_all = torch.randn(shape, device="cuda", generator=gen)
    v_all = torch.randn(shape, device="cuda", generator=gen)
    return k_all.to(torch.bfloat16), v_all.to(torch.bfloat16)


@pytest.mark.parametrize("kv_mul", [1, 2, 4, 8])
@pytest.mark.parametrize("hs", [64, 128])
@pytest.mark.parametrize("pos", [0, 5, 39])
def test_attention_kernel_bf16_cache_matches_plain(gen, kv_mul, hs, pos):
    k_all, v_all = _bf16_caches(gen, (2, 40, 2, hs))
    q = torch.randn((2 * kv_mul, hs), device="cuda", generator=gen)
    before = attention.KERNEL_KVBF16.launches
    got = attention.decode_attention(q, k_all, v_all, 1, pos, kv_mul)
    torch.cuda.synchronize()
    assert attention.KERNEL_KVBF16.launches == before + 1
    want = attention.decode_attention_plain(q, k_all, v_all, 1, pos, kv_mul)
    assert (got - want).abs().max().item() <= attention.KERNEL_ATOL


@pytest.mark.parametrize("kv_mul", [1, 2, 4, 8])
@pytest.mark.parametrize("pos,t_len", [(0, 2), (5, 33), (40, 70)])
def test_prefill_attention_kernel_bf16_cache_matches_plain(gen, kv_mul, pos,
                                                           t_len):
    k_all, v_all = _bf16_caches(gen, (2, 120, 2, 128))
    q = torch.randn((t_len, 2 * kv_mul, 128), device="cuda", generator=gen)
    before = attention.PREFILL_KERNEL_KVBF16.launches
    got = attention.prefill_attention(q, k_all, v_all, 1, pos, kv_mul)
    torch.cuda.synchronize()
    assert attention.PREFILL_KERNEL_KVBF16.launches == before + 1
    want = attention.prefill_attention_plain(q, k_all, v_all, 1, pos, kv_mul)
    assert (got - want).abs().max().item() <= attention.KERNEL_ATOL


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_mul", [1, 2, 4, 8])
@pytest.mark.parametrize("hs", [64, 128])
@pytest.mark.parametrize("pos,t_len", [(0, 9), (5, 33), (40, 70),
                                       (100, 120)])
def test_prefill_attention_bf16_kernel_matches_plain(gen, cache, kv_mul, hs,
                                                     pos, t_len):
    shape = (2, 240, 2, hs)
    k_all = torch.randn(shape, device="cuda", generator=gen).to(cache)
    v_all = torch.randn(shape, device="cuda", generator=gen).to(cache)
    q = torch.randn((t_len, 2 * kv_mul, hs), device="cuda", generator=gen)
    kernel = (attention.PREFILL_BF16_KERNEL if cache == torch.float32
              else attention.PREFILL_BF16_KERNEL_KVBF16)
    before = kernel.launches
    got = attention.prefill_attention(q, k_all, v_all, 1, pos, kv_mul,
                                      bf16=True)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = attention.prefill_attention_bf16_plain(q, k_all, v_all, 1, pos,
                                                  kv_mul)
    assert got.shape == want.shape == (t_len, 2 * kv_mul * hs)
    assert (got - want).abs().max().item() <= attention.KERNEL_ATOL_BF16
    # a poisoned suffix past pos + T - 1 stays unread
    k_all[1, pos + t_len:] = 1e4
    v_all[1, pos + t_len:] = float("nan")
    again = attention.prefill_attention(q, k_all, v_all, 1, pos, kv_mul,
                                        bf16=True)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_bf16_kernels_raise_instead_of_falling_back(gen):
    k_all = torch.randn((1, 16, 2, 40), device="cuda", generator=gen)
    q = torch.randn((4, 2, 40), device="cuda", generator=gen)
    with pytest.raises(ValueError, match="multiple of 16"):
        attention.prefill_attention(q, k_all, k_all, 0, 0, 1, bf16=True)
    kb = k_all[..., :32].contiguous()
    with pytest.raises(ValueError, match="both bfloat16"):
        attention.prefill_attention(q[..., :32].contiguous(), kb,
                                    kb.to(torch.bfloat16), 0, 0, 1,
                                    bf16=True)
    with pytest.raises(ValueError, match="q must be float32"):
        attention.decode_attention(q[0, :, :32].to(torch.bfloat16),
                                   kb.to(torch.bfloat16),
                                   kb.to(torch.bfloat16), 0, 0, 1)
    w = q40.random_q40(16, 64, "cuda", gen)
    x = torch.randn((9 * 64 + 1,), device="cuda", generator=gen)
    with pytest.raises(ValueError, match="x must be 16-byte aligned"):
        q40.q40_matmul(w, x[1:].view(9, 64), bf16=True)


def test_engine_fast_prefill_counts_launches(gen):
    """Engine(fast_prefill=True, cache_dtype=bf16).prefill at chunk 16 over
    40 tokens: three T = 16 windows, each 4L K3b and L K4b (bf16-cache
    build) launches, nothing else; its cache rows and next-step logits
    match the plain fast route on the card. The next decode step takes K1
    and the bf16-cache K2."""
    spec = TransformerSpec(dim=256, hidden_dim=704, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=300, seq_len=64,
                           weights_float_type=FloatType.Q40)
    kern = Engine(spec, synth_params(spec, q40=True, seed=6), "cuda",
                  cache_dtype=torch.bfloat16, fast_prefill=True)
    plain = llama.Llama(spec, kern.params, llama.FAST_PLAIN)
    cp = llama.init_cache(spec, "cuda", torch.bfloat16)
    tokens = [int(t) for t in torch.randint(2, 300, (40,), generator=torch
                                            .Generator().manual_seed(1))]
    kernels = (*q40.KERNELS, *attention.KERNELS)
    counts = [k.launches for k in kernels]
    kern.prefill(tokens, 0, 16)
    got = [k.launches for k in kernels]
    L = spec.n_layers
    assert [g - c for g, c in zip(got, counts)] == [
        0, 0, 0, 3 * 4 * L, 0, 0, 0, 0, 0, 0, 3 * L, 0, 0]
    with torch.inference_mode():
        run_chunked_prefill(
            lambda part, start: plain(cp, part, start, logits=False),
            tokens, 0, 16, spec.seq_len)
        b = llama.Llama(spec, kern.params, llama.PLAIN)(cp, 7, 40)[0]
    k_ref = cp.k[:, :40].float()
    assert ((kern.cache.k[:, :40].float() - k_ref).abs().max()
            <= llama.FAST_RTOL * k_ref.abs().max())
    counts = [k.launches for k in kernels]
    a = kern.infer(7, 40)
    got = [k.launches for k in kernels]
    assert [g - c for g, c in zip(got, counts)] == [
        4 * L + 1, 0, 0, 0, 0, 0, L, 0, 0, 0, 0, 0, 0]
    b = b.cpu().numpy()
    assert abs(a - b).max() <= llama.FAST_RTOL * abs(b).max()


# ---------------------------------------------------------------------------
# the batch slice: K5, K1d and the captured loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_mul", [1, 2, 4, 8])
@pytest.mark.parametrize("hs", [64, 128])
@pytest.mark.parametrize("batch,pos", [(1, [0]), (3, [5, 5, 5]),
                                       (3, [0, 39, 17]),
                                       (8, [1, 2, 3, 4, 39, 38, 0, 20])])
def test_batch_attention_kernel_matches_plain(gen, cache, kv_mul, hs, batch,
                                              pos):
    L, S = 2, 40
    k4 = torch.randn((L * batch, S, 2, hs), device="cuda",
                     generator=gen).to(cache)
    v4 = torch.randn((L * batch, S, 2, hs), device="cuda",
                     generator=gen).to(cache)
    q = torch.randn((batch, 2 * kv_mul, hs), device="cuda", generator=gen)
    pv = torch.tensor(pos, dtype=torch.int32, device="cuda")
    kernel = (attention.BATCH_KERNEL if cache == torch.float32
              else attention.BATCH_KERNEL_KVBF16)
    for layer in range(L):
        before = kernel.launches
        got = attention.decode_attention_batch(q, k4, v4, layer, pv, kv_mul)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        want = attention.decode_attention_batch_plain(q, k4, v4, layer, pv,
                                                      kv_mul)
        assert got.shape == want.shape == (batch, 2 * kv_mul * hs)
        assert (got - want).abs().max().item() <= attention.KERNEL_ATOL


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_mul", [1, 8])
@pytest.mark.parametrize("pos", [0, 17, 39])
def test_batch_attention_kernel_at_b1_is_k2_bit_for_bit(gen, cache, kv_mul,
                                                        pos):
    """K5 at B = 1 over an (L, S, n_kv, hs) cache computes K2's sums in
    K2's order: the --fast step's attention equals the host loop's."""
    k_all = torch.randn((3, 40, 2, 128), device="cuda",
                        generator=gen).to(cache)
    v_all = torch.randn((3, 40, 2, 128), device="cuda",
                        generator=gen).to(cache)
    q = torch.randn((1, 2 * kv_mul, 128), device="cuda", generator=gen)
    pv = torch.tensor([pos], dtype=torch.int32, device="cuda")
    for layer in range(3):
        a = attention.decode_attention_batch(q, k_all, v_all, layer, pv,
                                             kv_mul)
        b = attention.decode_attention(q[0], k_all, v_all, layer, pos,
                                       kv_mul)
        assert torch.equal(a, b)


def test_batch_attention_kernel_raises_instead_of_falling_back(gen):
    k4 = torch.randn((4, 16, 2, 64), device="cuda", generator=gen)
    q = torch.randn((2, 2, 64), device="cuda", generator=gen)
    pv = torch.tensor([3, 4], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        attention.decode_attention_batch(q, k4, k4, 0, pv.long(), 1)
    with pytest.raises(ValueError, match="int32"):
        attention.decode_attention_batch(q, k4, k4, 0, pv.cpu(), 1)
    with pytest.raises(ValueError, match="out of range"):
        attention.decode_attention_batch(q, k4, k4, 2, pv, 1)
    with pytest.raises(ValueError, match="with B = 3"):
        attention.decode_attention_batch(
            torch.randn((3, 2, 64), device="cuda"), k4, k4, 0,
            torch.zeros(3, dtype=torch.int32, device="cuda"), 1)
    with pytest.raises(ValueError, match="on cpu"):
        attention.decode_attention_batch(q, k4.cpu(), k4.cpu(), 0, pv, 1)


@pytest.mark.parametrize("d,n,t", [(1, 32, 2), (7, 64, 3), (9, 4096, 4),
                                   (33, 32 * 129, 5), (100, 4096, 6),
                                   (64, 11008, 8), (5, 28672, 7),
                                   (40, 32 * 3, 8)])
def test_q40_dequant_body_kernel_matches_plain(gen, d, n, t):
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((t, n), device="cuda", generator=gen)
    counts = [k.launches for k in q40.KERNELS]
    got = q40.q40_matmul(w, x, multi_body="dequant")
    torch.cuda.synchronize()
    assert [k.launches for k in q40.KERNELS] == [*counts[:4], counts[4] + 1]
    want = q40.q40_matmul_bf16_plain(w, x)
    assert got.shape == want.shape == (t, d)
    err = (got - want).abs().max().item()
    assert err <= q40.KERNEL_RTOL_BF16 * want.abs().max().item(), err


def test_q40_dequant_body_reads_scales_at_an_odd_offset(gen):
    """The f16 scales of a layer view may start at any 2-byte offset."""
    w = q40.random_q40(33, 32 * 129, "cuda", gen)
    raw = torch.empty(w.d16.numel() + 1, dtype=torch.float16, device="cuda")
    raw[1:] = w.d16.reshape(-1)
    odd = Q40Weight(w.qs, raw[1:].view(w.d16.shape))
    x = torch.randn((6, 32 * 129), device="cuda", generator=gen)
    got = q40.q40_matmul(odd, x, multi_body="dequant")
    want = q40.q40_matmul_bf16_plain(w, x)
    err = (got - want).abs().max().item()
    assert err <= q40.KERNEL_RTOL_BF16 * want.abs().max().item(), err


def test_q40_dequant_body_raises_instead_of_falling_back(gen):
    w = q40.random_q40(16, 64, "cuda", gen)
    x = torch.randn((4 * 64 + 1,), device="cuda", generator=gen)
    with pytest.raises(ValueError, match="x must be 16-byte aligned"):
        q40.q40_matmul(w, x[1:].view(4, 64), multi_body="dequant")
    with pytest.raises(ValueError, match="multi_body"):
        q40.q40_matmul(w, torch.randn((4, 64), device="cuda"),
                       multi_body="mxu")
    with pytest.raises(ValueError, match="on cpu"):
        q40.q40_matmul(Q40Weight(w.qs.cpu(), w.d16),
                       torch.randn((4, 64), device="cuda"),
                       multi_body="dequant")


def _small_spec(seq_len=48):
    return TransformerSpec(dim=256, hidden_dim=704, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=300, seq_len=seq_len,
                           weights_float_type=FloatType.Q40)


def _deltas(before):
    return {k.symbol: k.launches - n for k, n in before.items()
            if k.launches != n}


@pytest.mark.parametrize("body", ["vpu", "dequant"])
def test_forward_batch_kernels_match_plain_and_count_launches(gen, body):
    spec = _small_spec()
    params = llama.params_to_device(synth_params(spec, q40=True, seed=5),
                                    "cuda")
    route = llama.with_body(llama.KERNELS, body)
    kern = llama.Llama(spec, params, route)
    plain = llama.Llama(spec, params, llama.with_body(llama.PLAIN, body))
    B, L = 3, spec.n_layers
    ck = llama.init_cache_batch(spec, B, "cuda")
    cp = llama.init_cache_batch(spec, B, "cuda")
    rtol = llama.LOGIT_RTOL if body == "vpu" else llama.FAST_RTOL
    small = "q40_matvec_multi" if body == "vpu" else "q40_matvec_bf16"
    with torch.inference_mode():
        for step, pos in enumerate(([0, 0, 0], [1, 1, 1], [2, 9, 40])):
            tokens = torch.tensor([1 + step, 40, 299], device="cuda")
            pv = torch.tensor(pos, dtype=torch.int32, device="cuda")
            before = {k: k.launches for k in (*q40.KERNELS,
                                              *attention.KERNELS)}
            a = kern.forward_batch(ck, tokens, pv)
            assert _deltas(before) == {small: 4 * L + 1,
                                       "decode_attention_batch": L}
            b = plain.forward_batch(cp, tokens, pv)
            assert torch.isfinite(a).all()
            err = (a - b).abs().max().item()
            assert err <= rtol * b.abs().max().item(), (step, err)


def _loop_streams(gen, batch, temperature, topp, body="vpu", steps=14):
    """The batch loop's tokens with the step captured and replayed, and
    eagerly, over the same model and prompts, with each run's launches."""
    from distributed_llama_tpu_torch.runtime.decode import DecodeLoop

    spec = _small_spec()
    params = llama.params_to_device(synth_params(spec, q40=True, seed=5,
                                                 scale=0.3), "cuda")
    model = llama.Llama(spec, params, llama.with_body(llama.KERNELS, body))
    rng = np.random.default_rng(batch)
    prompts = np.full((batch, steps + 1), -1)
    for b in range(batch):
        n = 1 + b % 4
        prompts[b, :n] = rng.integers(2, spec.vocab_size, n)
    coins = rng.random((batch, steps)).astype(np.float32)
    results = {}
    for graph in (True, False):
        cache = llama.init_cache_batch(spec, batch, "cuda")
        loop = DecodeLoop(lambda t, p: model.forward_batch(cache, t, p),
                          batch, steps, temperature, topp, "cuda", graph)
        before = {k: k.launches for k in (*q40.KERNELS, *attention.KERNELS)}
        with torch.inference_mode():
            out, ran = loop.run(prompts, prompts[:, 0], coins,
                                np.zeros(batch, np.int32), steps)
        torch.cuda.synchronize()
        results[graph] = (out, ran, _deltas(before), loop)
    return spec, results


@pytest.mark.parametrize("batch,body", [(1, "vpu"), (3, "vpu"),
                                        (3, "dequant"), (9, "vpu")])
@pytest.mark.parametrize("temperature,topp", [(0.0, 0.9), (0.8, 0.9),
                                              (0.9, 0.0)])
def test_captured_batch_loop_matches_eager_with_exact_launches(
        gen, batch, body, temperature, topp):
    spec, res = _loop_streams(gen, batch, temperature, topp, body)
    (g_out, g_ran, g_counts, loop), (e_out, e_ran, e_counts, _) = \
        res[True], res[False]
    assert loop.replays == g_ran - 1  # the first step is the warm-up
    assert g_ran == e_ran and np.array_equal(g_out, e_out)
    L = spec.n_layers
    small = {1: "q40_matvec", 9: "q40_gemm"}.get(
        batch, "q40_matvec_multi" if body == "vpu" else "q40_matvec_bf16")
    want = {small: (4 * L + 1) * g_ran, "decode_attention_batch": L * g_ran}
    assert g_counts == e_counts == want


def test_captured_fast_loop_matches_the_host_loop(gen):
    """Greedy generate_fast with the step captured, and eagerly, against
    generate on the same engine: equal streams. The captured run launches
    K1 and K5 (never K2) once per step run and layer: the warm-up step and
    every replay."""
    from distributed_llama_tpu_torch.runtime.generate import (generate,
                                                              generate_fast)
    from distributed_llama_tpu_torch.runtime.sampling import Sampler

    class Tok:  # ids as pieces: the prompt is 1, 9, 40
        def encode(self, text, bos=True, eos=False):
            return [1, 9, 40]

        def decode_piece(self, prev, tok):
            return b"."

    spec = _small_spec()
    engine = Engine(spec, synth_params(spec, q40=True, seed=5, scale=0.3),
                    "cuda")
    streams, launches = {}, {}
    for label, run, kw in (("host", generate, {}),
                           ("graph", generate_fast, {"graph": True}),
                           ("eager", generate_fast, {"graph": False})):
        engine.reset()
        before = {k: k.launches for k in (*q40.KERNELS, *attention.KERNELS)}
        streams[label], _ = run(engine, Tok(), Sampler(300, 0.0, 0.9, 3),
                                "", 30, quiet=True, **kw)
        launches[label] = _deltas(before)
    assert streams["graph"] == streams["eager"] == streams["host"]
    L = spec.n_layers
    ran = engine.decode_loop(0.0, 0.9, True).replays + 1
    assert launches["graph"] == {"q40_matvec": (4 * L + 1) * ran,
                                 "decode_attention_batch": L * ran}
    assert set(launches["host"]) == {"q40_matvec", "decode_attention"}
