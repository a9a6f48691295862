"""The port's CUDA kernels against their plain versions on the card: the
tensor-core f32 decode matvecs (K1, K1m) at every T on 7B's shapes and
13B's and 70B's w2, with their bits, split-K tickets and graph replays;
then the small and ragged shapes that chip_smoke.py's 7B shapes do not reach: row
counts off the kernels' row blocks, block counts off their unrolls, stages
and x slices, odd T, an input width whose staged x needs more than 48 KB
of shared memory (70B's w2), head sizes below 128, and every kv_mul the
attention kernels are built for; then the forward and Engine.prefill
through the kernels, with their launch counts; the same for the bf16
kernels (K3b, K4b: their split-K and split-key plans, the launches of their
parts, the same bits from two launches, a long prefix) and the bf16-cache
builds of K2, K4 and K4b, and the ``--fast-prefill`` Engine over a bf16
cache; then the batched decode
attention (K5, both caches; at B = 1 bit for bit K2), K2's and K5's keys
split across the grid at S = 2048 (plain, the same bits twice, graph
replays across split boundaries with every ticket back at 0), K6's and
K7's split walk (K6 at t_len 1 K5's bits under the default plan, one split
and (32, 64) over the identity and a permuted pool, K7 K6's bits over the
dequantized pool under every plan, windows against plain at the
budget-edge clamp, verify and mixed windows up to t_len 39, graph
replays with every ticket back at 0) and the small-T bf16-product Q40
body (K1d), the continuous engine's captured verify and mixed dispatches
against eager ones bit for bit and its spec-on greedy streams against
spec-off, and the on-device loops: a step
captured in a CUDA graph and replayed gives the tokens of the same step
run eagerly, with exact launch counts; last, the chaos drills on the
card (the profiler drill captures every graph before the profiler
starts; the whole suite green, its mutation arms red). Every test takes
the ``gen``
fixture, which skips it without a GPU; on one, run

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


# K3's token tiles (16, 32, 64, 128) at T = 9, 16, 32 and 100, split K
# (130 rows over 344 blocks) and unsplit (one block)
@pytest.mark.parametrize("d,n", [(130, 11008), (7, 32)])
@pytest.mark.parametrize("t", [9, 16, 32, 100])
def test_q40_gemm_kernel_gives_the_same_bits_twice(gen, d, n, t):
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((t, n), device="cuda", generator=gen)
    parts = [k.launches for k in q40.HELPERS]
    got = q40.q40_matmul(w, x)
    splits = q40.gemm_tf32_plan(t, d, n // 32, _sms())[0]
    # the x split pass once, K3b's split-K sum where the plan splits
    assert [k.launches - c for k, c in zip(q40.HELPERS, parts)] == [
        0, int(splits > 1), 1]
    assert torch.equal(q40.q40_matmul(w, x), got)
    want = q40.q40_matmul_plain(w, x)
    err = (got - want).abs().max().item()
    assert err <= q40.KERNEL_RTOL * want.abs().max().item(), err


# 13B's and 70B's w2 at T = 512: the whole sum (432 and 896 Q40 blocks)
# in one split, and as the wrapper's plan splits it
@pytest.mark.parametrize("d,n", [(5120, 13824), (8192, 28672)])
def test_q40_gemm_kernel_holds_its_tolerance_at_13b_and_70b_depth(gen, d, n):
    t, nb = 512, n // 32
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((t, n), device="cuda", generator=gen)
    want = q40.q40_matmul_plain(w, x)
    xs = torch.empty((2, t, n), device="cuda")
    one = torch.empty((t, d), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    q40.KERNEL_SPLIT_TF32.launch(x.data_ptr(), xs[0].data_ptr(),
                                 xs[1].data_ptr(), x.numel(), stream)
    q40.KERNEL_GEMM.launch(w.qs.data_ptr(), w.d16.data_ptr(),
                           xs[0].data_ptr(), xs[1].data_ptr(), one.data_ptr(),
                           t, d, nb, 1, 2, stream)
    for got in (one, q40.q40_matmul(w, x)):
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


# K1 (T = 1) and K1m (T = 2..8) on tensor cores: 7B's shapes at every T,
# 13B's and 70B's w2 (432 and 896 Q40 blocks) at T = 1, 2 and 8, each
# against plain within KERNEL_RTOL and the same bits from two launches
K1_SHAPES = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008),
             (32000, 4096)]


@pytest.mark.parametrize("t", range(1, 9))
@pytest.mark.parametrize("d,n", K1_SHAPES)
def test_q40_matvec_kernels_match_plain_at_7b_shapes(gen, d, n, t):
    _matvec_case(gen, d, n, t)


@pytest.mark.parametrize("t", [1, 2, 8])
@pytest.mark.parametrize("d,n", [(5120, 13824), (8192, 28672)])
def test_q40_matvec_kernels_hold_their_tolerance_at_13b_and_70b_depth(
        gen, d, n, t):
    _matvec_case(gen, d, n, t)


# ragged rows and block counts: rows past the last tile, splits of unequal
# length, fewer blocks than a stage
@pytest.mark.parametrize("t", [1, 3, 8])
@pytest.mark.parametrize("d,n", [(1, 32), (7, 64), (37, 96), (33, 32 * 129),
                                 (100, 32 * 7), (5, 28672), (300, 32 * 345),
                                 (3, 32 * 2048)])
def test_q40_matvec_kernels_at_ragged_shapes(gen, d, n, t):
    _matvec_case(gen, d, n, t)


def _matvec_case(gen, d, n, t):
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((t, n), device="cuda", generator=gen)
    kernel = q40.KERNEL if t == 1 else q40.KERNEL_MULTI
    before = kernel.launches
    got = q40.q40_matmul(w, x)
    again = q40.q40_matmul(w, x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2  # one launch a call, splits too
    assert torch.equal(got, again)
    want = q40.q40_matmul_plain(w, x)
    assert got.shape == want.shape == (t, d)
    err = (got - want).abs().max().item()
    assert err <= q40.KERNEL_RTOL * want.abs().max().item(), err
    assert not q40._tickets(x.device).any()  # every ticket back at 0


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("d,n", [(33, 32 * 129), (8, 64)])
def test_q40_matvec_reads_scales_at_an_odd_offset(gen, d, n, t):
    """K1 and K1m copy the f16 scales as aligned 32-bit words: scales that
    start in the second half of one, with an odd count."""
    w = q40.random_q40(d, n, "cuda", gen)
    raw = torch.empty(w.d16.numel() + 1, dtype=torch.float16, device="cuda")
    raw[1:] = w.d16.reshape(-1)
    odd = Q40Weight(w.qs, raw[1:].view(w.d16.shape))
    x = torch.randn((t, n), device="cuda", generator=gen)
    got = q40.q40_matmul(odd, x)
    want = q40.q40_matmul_plain(w, x)
    err = (got - want).abs().max().item()
    assert err <= q40.KERNEL_RTOL * want.abs().max().item(), err


@pytest.mark.parametrize("t", [1, 8])
def test_q40_matvec_split_k_replays_from_a_graph(gen, t):
    """70B's w2 splits K (several blocks add each tile behind a ticket):
    captured in a CUDA graph and replayed on new inputs, every replay
    gives the eager bits and leaves every ticket at 0."""
    d, n = 8192, 28672
    assert q40.matvec_plan(t, d, n // 32, _sms())[3] > 1
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((t, n), device="cuda", generator=gen)
    q40.q40_matmul(w, x)  # the eager first call (tickets, opt-in)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = q40.q40_matmul(w, x)
    for seed in range(3):
        x.copy_(torch.randn((t, n), device="cuda", generator=gen))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, q40.q40_matmul(w, x)), seed
        assert not q40._tickets(x.device).any()
    want = q40.q40_matmul_plain(w, x)
    err = (out - want).abs().max().item()
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


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_kv,kv_mul,pos,t_len", [(2, 1, 1900, 37),
                                                    (32, 1, 384, 128),
                                                    (2, 8, 200, 16)])
def test_prefill_attention_kernel_splits_and_gives_the_same_bits_twice(
        gen, cache, n_kv, kv_mul, pos, t_len):
    """K4 over a long prefix, split over keys where prefill_plan splits
    (K4b's combine launched once), against plain within KERNEL_ATOL, the
    same bits from a second launch."""
    shape = (1, 2048, n_kv, 128)
    k_all = torch.randn(shape, device="cuda", generator=gen).to(cache)
    v_all = torch.randn(shape, device="cuda", generator=gen).to(cache)
    q = torch.randn((t_len, n_kv * kv_mul, 128), device="cuda", generator=gen)
    splits, _ = attention.prefill_plan(pos, t_len, kv_mul, n_kv, _sms())
    before = attention.PREFILL_BF16_COMBINE.launches
    got = attention.prefill_attention(q, k_all, v_all, 0, pos, kv_mul)
    assert attention.PREFILL_BF16_COMBINE.launches - before == int(splits > 1)
    assert torch.equal(
        attention.prefill_attention(q, k_all, v_all, 0, pos, kv_mul), got)
    want = attention.prefill_attention_plain(q, k_all, v_all, 0, pos, kv_mul)
    assert (got - want).abs().max().item() <= attention.KERNEL_ATOL


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
    k12 = torch.randn((1, 16, 2, 12), device="cuda", generator=gen)
    with pytest.raises(ValueError, match="multiple of 8"):
        attention.prefill_attention(torch.randn((4, 2, 12), device="cuda"),
                                    k12, k12, 0, 0, 1)


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

def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


# (130, 11008, 17) and (65, 32 * 129, 300) split K (the second over an odd
# block count, T > 256, a last split shorter than the rest)
@pytest.mark.parametrize("d,n,t", [(1, 32, 9), (7, 64, 16), (65, 4096, 17),
                                   (64, 96, 33), (33, 32 * 129, 100),
                                   (130, 11008, 128), (3, 64, 300),
                                   (130, 11008, 17), (65, 32 * 129, 300)])
def test_q40_gemm_bf16_kernel_matches_plain(gen, d, n, t):
    """K3b and its parts: one x rounding pass, one GEMM, and the split-K
    sum exactly when gemm_bf16_plan splits."""
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((t, n), device="cuda", generator=gen)
    counts = [k.launches for k in (*q40.KERNELS, *q40.HELPERS)]
    got = q40.q40_matmul(w, x, bf16=True)
    torch.cuda.synchronize()
    splits = q40.gemm_bf16_plan(t, d, n // 32, _sms())[0]
    assert [k.launches for k in (*q40.KERNELS, *q40.HELPERS)] == [
        *counts[:3], counts[3] + 1, counts[4], counts[5] + 1,
        counts[6] + (splits > 1), *counts[7:]]
    want = q40.q40_matmul_bf16_plain(w, x)
    assert got.shape == want.shape == (t, d)
    err = (got - want).abs().max().item()
    assert err <= q40.KERNEL_RTOL_BF16 * want.abs().max().item(), err


@pytest.mark.parametrize("d,n,t", [(130, 11008, 17), (65, 32 * 129, 300),
                                   (4096, 4096, 128)])
def test_q40_gemm_bf16_kernel_gives_the_same_bits_twice(gen, d, n, t):
    """No float atomics: the split-K partials are summed in split order."""
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((t, n), device="cuda", generator=gen)
    assert q40.gemm_bf16_plan(t, d, n // 32, _sms())[0] > 1
    assert torch.equal(q40.q40_matmul(w, x, bf16=True),
                       q40.q40_matmul(w, x, bf16=True))


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


def test_q40_gemm_bf16_reads_no_scale_past_the_last(gen):
    """Scales that fill their own allocation, ending on a 2 MiB boundary
    (as 7B's stacked wqkv scales do): K3b copies no word past the last
    pair (a window past it faulted at full width)."""
    d, n = 8192, 4096  # d * nb * 2 bytes = 2 MiB
    w = q40.random_q40(d, n, "cuda", gen)
    d16 = torch.empty((d, n // 32), dtype=torch.float16, device="cuda")
    d16.copy_(w.d16)
    x = torch.randn((128, n), device="cuda", generator=gen)
    got = q40.q40_matmul(Q40Weight(w.qs, d16), x, bf16=True)
    torch.cuda.synchronize()
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


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_kv,kv_mul,pos,t_len", [(2, 1, 1900, 37),
                                                   (2, 8, 1500, 100),
                                                   (64, 1, 1700, 300)])
def test_prefill_attention_bf16_kernel_at_a_long_prefix(gen, cache, n_kv,
                                                        kv_mul, pos, t_len):
    """K4b over a long prefix, split across blocks (the first two cases) or
    not (64 kv heads fill the card): the plain version within
    KERNEL_ATOL_BF16, the combine launched exactly when the plan splits,
    the same bits from a second launch, and a poisoned suffix unread."""
    shape = (2, 2048, n_kv, 128)
    k_all = torch.randn(shape, device="cuda", generator=gen).to(cache)
    v_all = torch.randn(shape, device="cuda", generator=gen).to(cache)
    q = torch.randn((t_len, n_kv * kv_mul, 128), device="cuda",
                    generator=gen)
    splits, _ = attention.prefill_bf16_plan(
        pos, t_len, kv_mul, n_kv, attention.PREFILL_BF16_KEYS[cache], _sms())
    assert (splits > 1) == (n_kv == 2)
    kernel = attention._PREFILL[True, cache]
    before = (kernel.launches, attention.PREFILL_BF16_COMBINE.launches)
    got = attention.prefill_attention(q, k_all, v_all, 1, pos, kv_mul,
                                      bf16=True)
    torch.cuda.synchronize()
    assert (kernel.launches, attention.PREFILL_BF16_COMBINE.launches) == (
        before[0] + 1, before[1] + (splits > 1))
    want = attention.prefill_attention_bf16_plain(q, k_all, v_all, 1, pos,
                                                  kv_mul)
    assert (got - want).abs().max().item() <= attention.KERNEL_ATOL_BF16
    assert torch.equal(attention.prefill_attention(q, k_all, v_all, 1, pos,
                                                   kv_mul, bf16=True), got)
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
    parts = (*q40.HELPERS, *attention.HELPERS)
    counts = [k.launches for k in kernels]
    part_counts = [k.launches for k in parts]
    kern.prefill(tokens, 0, 16)
    got = [k.launches for k in kernels]
    L = spec.n_layers
    assert [g - c for g, c in zip(got, counts)] == [
        0, 0, 0, 3 * 4 * L, 0, 0, 0, 0, 0, 0, 3 * L, 0, 0]
    # K3b's x rounding per launch; its split-K sum and K4b's combine where
    # their plans split (at these widths neither does)
    shapes = [(512, 256), (256, 256), (1408, 256), (256, 704)]
    reduces = sum(q40.gemm_bf16_plan(16, d, n // 32, _sms())[0] > 1
                  for d, n in shapes)
    combines = sum(attention.prefill_bf16_plan(
        p, 16, 2, 2, attention.PREFILL_BF16_KEYS[torch.bfloat16],
        _sms())[0] > 1 for p in (0, 16, 32))
    assert [k.launches - c for k, c in zip(parts, part_counts)] == [
        3 * 4 * L, 3 * L * reduces, 0, L * combines]
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


def _split_caches(gen, cache, rows, n_kv, hs=128, S=2048):
    k4 = torch.randn((rows, S, n_kv, hs), device="cuda",
                     generator=gen).to(cache)
    v4 = torch.randn((rows, S, n_kv, hs), device="cuda",
                     generator=gen).to(cache)
    return k4, v4


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_kv,kv_mul", [(32, 1), (8, 8), (4, 2)])
def test_split_attention_kernels_at_a_long_prefix(gen, cache, n_kv, kv_mul):
    """K2 and K5 at S = 2048 split each kv head's keys across the grid
    (decode_plan): against plain at pos 2047 and ragged clocks, the same
    bits on a second launch, every ticket back at 0."""
    q = torch.randn((3, n_kv * kv_mul, 128), device="cuda", generator=gen)
    k_all, v_all = _split_caches(gen, cache, 2, n_kv)
    splits = attention.decode_splits(2048, attention.decode_plan(
        n_kv, 1, _sms()))[0]
    assert splits > 1
    got = attention.decode_attention(q[0], k_all, v_all, 1, 2047, kv_mul)
    want = attention.decode_attention_plain(q[0], k_all, v_all, 1, 2047,
                                            kv_mul)
    assert (got - want).abs().max().item() <= attention.KERNEL_ATOL
    assert torch.equal(got, attention.decode_attention(
        q[0], k_all, v_all, 1, 2047, kv_mul))
    k4, v4 = _split_caches(gen, cache, 6, n_kv)
    pv = torch.tensor([2047, 300, 5], dtype=torch.int32, device="cuda")
    got = attention.decode_attention_batch(q, k4, v4, 1, pv, kv_mul)
    want = attention.decode_attention_batch_plain(q, k4, v4, 1, pv, kv_mul)
    assert (got - want).abs().max().item() <= attention.KERNEL_ATOL
    assert torch.equal(got, attention.decode_attention_batch(
        q, k4, v4, 1, pv, kv_mul))
    for key, s in attention._DECODE_SCRATCH.items():
        assert not s.tickets.any(), key


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_mul", [1, 8])
@pytest.mark.parametrize("pos", [1000, 2047])
def test_split_attention_k5_at_b1_is_k2_bit_for_bit(gen, cache, kv_mul,
                                                    pos):
    """K5 at B = 1 takes K2's plan at every position: the --fast step's
    attention equals the host loop's past the first split too."""
    n_kv = 8
    k_all, v_all = _split_caches(gen, cache, 2, n_kv)
    q = torch.randn((1, n_kv * kv_mul, 128), device="cuda", generator=gen)
    pv = torch.tensor([pos], dtype=torch.int32, device="cuda")
    assert attention.decode_splits(pos + 1, attention.decode_plan(
        n_kv, 1, _sms()))[0] > 1
    for layer in range(2):
        assert torch.equal(
            attention.decode_attention_batch(q, k_all, v_all, layer, pv,
                                             kv_mul),
            attention.decode_attention(q[0], k_all, v_all, layer, pos,
                                       kv_mul))


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
def test_split_attention_replays_from_a_graph(gen, cache):
    """K5 captured in a CUDA graph (device positions, static scratch) and
    replayed at clocks that cross split boundaries (1, then several
    splits, then others): every replay gives the eager bits and leaves
    every ticket at 0."""
    n_kv, kv_mul, batch = 8, 4, 2
    k4, v4 = _split_caches(gen, cache, 2 * batch, n_kv)
    q = torch.randn((batch, n_kv * kv_mul, 128), device="cuda",
                    generator=gen)
    pv = torch.tensor([5, 40], dtype=torch.int32, device="cuda")
    attention.decode_attention_batch(q, k4, v4, 1, pv, kv_mul)  # eager
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = attention.decode_attention_batch(q, k4, v4, 1, pv, kv_mul)
    plan = attention.decode_plan(n_kv, batch, _sms())
    seen = set()
    for pos in ([0, 127], [128, 2047], [1000, 129], [2047, 256], [3, 900]):
        pv.copy_(torch.tensor(pos, dtype=torch.int32))
        q.copy_(torch.randn(q.shape, device="cuda", generator=gen))
        graph.replay()
        torch.cuda.synchronize()
        replayed = out.clone()
        for key, s in attention._DECODE_SCRATCH.items():
            assert not s.tickets.any(), (key, pos)
        assert torch.equal(replayed, attention.decode_attention_batch(
            q, k4, v4, 1, pv, kv_mul)), pos
        want = attention.decode_attention_batch_plain(q, k4, v4, 1, pv,
                                                      kv_mul)
        assert (replayed - want).abs().max().item() <= attention.KERNEL_ATOL
        seen |= {attention.decode_splits(p + 1, plan)[0] for p in pos}
    assert 1 in seen and len(seen) > 2


def test_split_attention_plan_override(gen):
    """A plan override reaches the kernel: ONE_SPLIT gives the same
    values within KERNEL_ATOL, a plan out of range raises."""
    k_all, v_all = _split_caches(gen, torch.float32, 2, 8)
    q = torch.randn((8, 128), device="cuda", generator=gen)
    a = attention.decode_attention(q, k_all, v_all, 1, 2047, 1)
    b = attention.decode_attention(q, k_all, v_all, 1, 2047, 1,
                                   plan=attention.ONE_SPLIT)
    assert (a - b).abs().max().item() <= attention.KERNEL_ATOL
    with pytest.raises(ValueError, match="plan"):
        attention.decode_attention(q, k_all, v_all, 1, 2047, 1,
                                   plan=(attention.DECODE_MAX_SPLITS + 1, 1))
    with pytest.raises(ValueError, match="plan"):
        attention.decode_attention(q, k_all, v_all, 1, 2047, 1, plan=(2, 0))


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


# K1d on K1m's skeleton: 7B's layer shapes and 70B's w2 (896 Q40 blocks,
# split K) at every T, each within KERNEL_RTOL_BF16 of plain, the same bits
# from two launches, every ticket back at 0
@pytest.mark.parametrize("t", range(2, 9))
@pytest.mark.parametrize("d,n", [*K1_SHAPES[:4], (8192, 28672)])
def test_q40_dequant_body_at_7b_and_70b_shapes(gen, d, n, t):
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((t, n), device="cuda", generator=gen)
    before = q40.KERNEL_MULTI_BF16.launches
    got = q40.q40_matmul(w, x, multi_body="dequant")
    again = q40.q40_matmul(w, x, multi_body="dequant")
    torch.cuda.synchronize()
    assert q40.KERNEL_MULTI_BF16.launches == before + 2
    assert torch.equal(got, again)
    want = q40.q40_matmul_bf16_plain(w, x)
    err = (got - want).abs().max().item()
    assert err <= q40.KERNEL_RTOL_BF16 * want.abs().max().item(), err
    assert not q40._tickets(x.device).any()


def test_q40_dequant_body_reads_back_its_bf16_weights_bit_for_bit(gen):
    """One-hot x, T = 8 tokens each e_j, over q40.sweep_q40 (codes 0..15 in
    every block, every finite f16 scale): each output is one weight times
    1, so K1d returns dequantize_q40_torch's weights rounded to bf16, bit
    for bit (the two-FMA rounding of csrc/q40_matvec.cuh scaled_bf16)."""
    from distributed_llama_tpu_torch.ops.quants import dequantize_q40_torch

    w = q40.sweep_q40("cuda")
    d, nb = w.d16.shape
    n = nb * 32
    want = dequantize_q40_torch(w.qs, w.d16).to(torch.bfloat16).float()
    got = torch.empty((d, n), device="cuda")
    eye = torch.eye(n, device="cuda")
    for j in range(0, n, 8):
        got[:, j:j + 8] = q40.q40_matmul(w, eye[j:j + 8],
                                         multi_body="dequant").T
    assert torch.equal(got, want)


@pytest.mark.parametrize("t", [2, 8])
def test_q40_dequant_body_split_k_replays_from_a_graph(gen, t):
    """70B's w2 splits K for K1d too: captured and replayed on new inputs,
    every replay gives the eager bits and leaves every ticket at 0."""
    d, n = 8192, 28672
    assert q40.matvec_plan(t, d, n // 32, _sms(), 1)[3] > 1
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((t, n), device="cuda", generator=gen)
    q40.q40_matmul(w, x, multi_body="dequant")  # the eager first call
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = q40.q40_matmul(w, x, multi_body="dequant")
    for seed in range(3):
        x.copy_(torch.randn((t, n), device="cuda", generator=gen))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, q40.q40_matmul(w, x, multi_body="dequant"))
        assert not q40._tickets(x.device).any()


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


# ---------------------------------------------------------------------------
# paged decode attention (K6 over f32 / bf16 pages, K7 over Q8 pages) and the
# continuous engine
# ---------------------------------------------------------------------------

from distributed_llama_tpu_torch.ops import paged_attention  # noqa: E402


def _paged_pool(gen, L, P, ps, n_kv, hs, dtype=torch.float32):
    shape = (L * P, ps, n_kv, hs)
    return (torch.randn(shape, device="cuda", generator=gen).to(dtype),
            torch.randn(shape, device="cuda", generator=gen).to(dtype))


def _scrambled(batch, max_pages, P, seed):
    ids = 1 + np.random.default_rng(seed).permutation(P - 1)[:batch
                                                            * max_pages]
    return torch.tensor(ids.reshape(batch, max_pages), dtype=torch.int32,
                        device="cuda")


def _q8_pool(k4, v4):
    from distributed_llama_tpu_torch.ops.quants import quantize_q80_torch

    rows, ps, n_kv, hs = k4.shape
    planes = []
    for x in (k4, v4):
        qs, d = quantize_q80_torch(x.reshape(rows, ps, n_kv * hs))
        planes += [qs.reshape(rows, ps, n_kv, hs).contiguous(),
                   d.contiguous()]
    return planes  # kq4, kd4, vq4, vd4


PAGED_POS = {1: [0, 13, 31], 4: [0, 9, 30], 8: [3, 17, 29]}


@pytest.mark.parametrize("pages", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("kv_mul", [1, 2, 4, 8])
@pytest.mark.parametrize("hs", [64, 128])
@pytest.mark.parametrize("t_len", [1, 4, 8])
@pytest.mark.parametrize("ps", [4, 16])
def test_paged_kernels_match_plain(gen, pages, kv_mul, hs, t_len, ps):
    """K6 (f32 and bf16 pages) and K7 at t_len 1, K6w and K7w at the
    windows of 4 and 8, against their plain versions over a scrambled
    table, mid-page clocks, and a window running past the virtual plane
    (the budget-edge clamp)."""
    L, n_kv, max_pages = 2, 2, 32 // ps
    P = 3 * max_pages + 2
    dtype = torch.bfloat16 if pages == "bf16" else torch.float32
    k4, v4 = _paged_pool(gen, L, P, ps, n_kv, hs, dtype)
    table = _scrambled(3, max_pages, P, seed=ps + hs)
    q = torch.randn((3, t_len, n_kv * kv_mul * hs), device="cuda",
                    generator=gen)
    pv = torch.tensor(PAGED_POS[t_len], dtype=torch.int32, device="cuda")
    window = t_len >= paged_attention.WINDOW_MIN_T
    if pages == "q8":
        planes = _q8_pool(k4, v4)
        run = paged_attention.paged_decode_attention_q8
        plain = paged_attention.paged_decode_attention_q8_plain
        kernel = (paged_attention.WINDOW_KERNEL_Q8 if window
                  else paged_attention.PAGED_KERNEL_Q8)
    else:
        planes = [k4, v4]
        run = paged_attention.paged_decode_attention
        plain = paged_attention.paged_decode_attention_plain
        kernel = {(False, "f32"): paged_attention.PAGED_KERNEL,
                  (False, "bf16"): paged_attention.PAGED_KERNEL_KVBF16,
                  (True, "f32"): paged_attention.WINDOW_KERNEL,
                  (True, "bf16"): paged_attention.WINDOW_KERNEL_KVBF16}[
                      window, pages]
    for layer in range(L):
        before = kernel.launches
        got = run(q, *planes, layer, pv, table, P, kv_mul)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        want = plain(q, *planes, layer, pv, table, P, kv_mul)
        assert got.shape == want.shape == q.shape
        assert (got - want).abs().max().item() <= attention.KERNEL_ATOL


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_mul", [1, 8])
@pytest.mark.parametrize("ps", [4, 16])
def test_paged_kernel_at_t1_is_k5_bit_for_bit(gen, cache, kv_mul, ps):
    """A (L*B, S, n_kv, hs) batch cache is also a pool of L*B*S/ps pages:
    with the identity table K6 gives the bits of K5 at a one-split plan
    (the first design's sums in its order), and under any permutation of
    the physical pages it gives the same bits again."""
    L, B, S, n_kv, hs = 2, 3, 48, 2, 128
    k4 = torch.randn((L * B, S, n_kv, hs), device="cuda",
                     generator=gen).to(cache)
    v4 = torch.randn((L * B, S, n_kv, hs), device="cuda",
                     generator=gen).to(cache)
    q = torch.randn((B, n_kv * kv_mul, hs), device="cuda", generator=gen)
    pv = torch.tensor([0, 29, 47], dtype=torch.int32, device="cuda")
    mp = S // ps
    P = B * mp
    table = torch.arange(P, dtype=torch.int32,
                         device="cuda").reshape(B, mp)
    perm = torch.randperm(P, device="cuda", generator=gen)
    for layer in range(L):
        k5 = attention.decode_attention_batch(q, k4, v4, layer, pv, kv_mul,
                                              plan=attention.ONE_SPLIT)
        pages = [t.reshape(L * P, ps, n_kv, hs) for t in (k4, v4)]
        k6 = paged_attention.paged_decode_attention(
            q.reshape(B, 1, -1), *pages, layer, pv, table, P, kv_mul)
        assert torch.equal(k6.reshape(B, -1), k5)
        moved = []
        for t in pages:
            m = torch.empty_like(t).reshape(L, P, ps, n_kv, hs)
            m[:, perm] = t.reshape(L, P, ps, n_kv, hs)
            moved.append(m.reshape(L * P, ps, n_kv, hs))
        k6p = paged_attention.paged_decode_attention(
            q.reshape(B, 1, -1), *moved, layer, pv,
            perm.to(torch.int32)[table.long()], P, kv_mul)
        assert torch.equal(k6p, k6)


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_mul", [1, 8])
def test_paged_kernel_at_a_long_prefix_is_k5_at_one_split(gen, cache,
                                                          kv_mul):
    """Past the first split of K5's default plan, K6 over the same values
    gives K5's bits at the one-split plan, and at the default plan K5's
    bits at its default plan, within KERNEL_ATOL of the one-split ones."""
    L, B, S, n_kv, hs, ps = 2, 2, 2048, 8, 128, 16
    k4, v4 = _split_caches(gen, cache, L * B, n_kv, hs, S)
    q = torch.randn((B, n_kv * kv_mul, hs), device="cuda", generator=gen)
    pv = torch.tensor([2047, 1000], dtype=torch.int32, device="cuda")
    P = B * S // ps
    table = torch.arange(P, dtype=torch.int32,
                         device="cuda").reshape(B, S // ps)
    pages = [t.reshape(L * P, ps, n_kv, hs) for t in (k4, v4)]
    k5 = attention.decode_attention_batch(q, k4, v4, 1, pv, kv_mul,
                                          plan=attention.ONE_SPLIT)
    k6 = paged_attention.paged_decode_attention(
        q.reshape(B, 1, -1), *pages, 1, pv, table, P, kv_mul,
        plan=attention.ONE_SPLIT)
    assert torch.equal(k6.reshape(B, -1), k5)
    split = attention.decode_attention_batch(q, k4, v4, 1, pv, kv_mul)
    assert attention.decode_splits(2048, attention.decode_plan(
        n_kv, B, _sms()))[0] > 1
    assert torch.equal(paged_attention.paged_decode_attention(
        q.reshape(B, 1, -1), *pages, 1, pv, table, P, kv_mul).reshape(B, -1),
        split)
    assert (split - k5).abs().max().item() <= attention.KERNEL_ATOL


@pytest.mark.parametrize("kv_mul", [1, 2, 8])
@pytest.mark.parametrize("t_len", [1, 4])
def test_paged_q8_kernel_is_k6_over_the_dequantized_pool(gen, kv_mul,
                                                         t_len):
    """K7 at t_len 1 and K7w at a verify window of 4: K6's and K6w's bits
    over the pool of the dequantized values."""
    from distributed_llama_tpu_torch.ops.quants import dequantize_q80_planes

    L, ps, n_kv, hs, max_pages = 2, 8, 4, 64, 4
    P = 2 * max_pages + 1
    k4, v4 = _paged_pool(gen, L, P, ps, n_kv, hs)
    kq4, kd4, vq4, vd4 = _q8_pool(k4, v4)
    deq = [dequantize_q80_planes(kq4, kd4).contiguous(),
           dequantize_q80_planes(vq4, vd4).contiguous()]
    table = _scrambled(2, max_pages, P, seed=3)
    q = torch.randn((2, t_len, n_kv * kv_mul * hs), device="cuda",
                    generator=gen)
    pv = torch.tensor([5, 31 - t_len + 1], dtype=torch.int32, device="cuda")
    for layer in range(L):
        a = paged_attention.paged_decode_attention_q8(
            q, kq4, kd4, vq4, vd4, layer, pv, table, P, kv_mul)
        b = paged_attention.paged_decode_attention(q, *deq, layer, pv, table,
                                                   P, kv_mul)
        assert torch.equal(a, b)


# K6's and K7's split walk (K5's, through the page table): the plans
# chip_smoke.py and the acceptance hold it to
PAGED_PLANS = [None, attention.ONE_SPLIT, (32, 64)]
# (n_kv, kv_mul): 7B's widths and 8 GQA kv heads, two layers, S 2048
PAGED_WIDTHS = [(32, 1), (8, 8)]


def _long_pool(gen, cache, n_kv, B=3, L=2, S=2048, ps=16, hs=128):
    """A (L*B, S, n_kv, hs) batch cache (its values as K5 reads them), the
    same values as an identity-mapped pool and as a permuted one: (k4, v4,
    identity pages, identity table, permuted pages, permuted table, P)."""
    k4, v4 = _split_caches(gen, cache, L * B, n_kv, hs, S)
    P = B * S // ps
    ident = torch.arange(P, dtype=torch.int32,
                         device="cuda").reshape(B, S // ps)
    pages = [t.reshape(L * P, ps, n_kv, hs) for t in (k4, v4)]
    perm = torch.randperm(P, device="cuda", generator=gen)
    moved = []
    for t in pages:
        m = torch.empty_like(t).reshape(L, P, ps, n_kv, hs)
        m[:, perm] = t.reshape(L, P, ps, n_kv, hs)
        moved.append(m.reshape(L * P, ps, n_kv, hs))
    return (k4, v4, pages, ident, moved,
            perm.to(torch.int32)[ident.long()].contiguous(), P)


def _no_tickets():
    for key, s in attention._DECODE_SCRATCH.items():
        assert not s.tickets.any(), key


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", PAGED_WIDTHS)
@pytest.mark.parametrize("plan", PAGED_PLANS)
def test_paged_split_kernel_at_t1_is_k5_bit_for_bit(gen, cache, width, plan):
    """K6 at t_len 1 under the default plan, ONE_SPLIT and (32, 64), over
    the identity and a permuted pool holding a contiguous cache's values:
    K5's bits under the same plan at pos 63, 2047 and ragged clocks, the
    same bits on a second launch, every ticket back at 0."""
    n_kv, kv_mul = width
    k4, v4, pages, ident, moved, table, P = _long_pool(gen, cache, n_kv)
    B = ident.shape[0]
    q = torch.randn((B, n_kv * kv_mul, 128), device="cuda", generator=gen)
    run = paged_attention.paged_decode_attention
    for pos in ([63] * B, [2047] * B, [5, 900, 2047]):
        pv = torch.tensor(pos, dtype=torch.int32, device="cuda")
        k5 = attention.decode_attention_batch(q, k4, v4, 1, pv, kv_mul,
                                              plan=plan)
        k6 = run(q.reshape(B, 1, -1), *pages, 1, pv, ident, P, kv_mul,
                 plan=plan)
        assert torch.equal(k6.reshape(B, -1), k5), pos
        k6p = run(q.reshape(B, 1, -1), *moved, 1, pv, table, P, kv_mul,
                  plan=plan)
        assert torch.equal(k6p, k6), pos
        assert torch.equal(run(q.reshape(B, 1, -1), *moved, 1, pv, table, P,
                               kv_mul, plan=plan), k6p), pos
        _no_tickets()


@pytest.mark.parametrize("width", PAGED_WIDTHS)
@pytest.mark.parametrize("plan", [*PAGED_PLANS, (4, 16)])
@pytest.mark.parametrize("t_len", [1, 4])
def test_paged_split_q8_kernel_is_k6_over_the_dequantized_pool(gen, width,
                                                               plan, t_len):
    """K7 (t_len 1) and K7w (t_len 4) under every plan at a long prefix:
    K6's and K6w's bits over the pool of its dequantized values, the same
    bits twice, tickets back at 0."""
    from distributed_llama_tpu_torch.ops.quants import dequantize_q80_planes

    n_kv, kv_mul = width
    _, _, _, _, moved, table, P = _long_pool(gen, torch.float32, n_kv)
    B = table.shape[0]
    planes = _q8_pool(*moved)
    deq = [dequantize_q80_planes(planes[0], planes[1]).contiguous(),
           dequantize_q80_planes(planes[2], planes[3]).contiguous()]
    q = torch.randn((B, t_len, n_kv * kv_mul * 128), device="cuda",
                    generator=gen)
    for pos in ([63] * B, [2047 - t_len + 1] * B, [5, 900, 2045]):
        pv = torch.tensor(pos, dtype=torch.int32, device="cuda")
        a = paged_attention.paged_decode_attention_q8(
            q, *planes, 1, pv, table, P, kv_mul, plan=plan)
        b = paged_attention.paged_decode_attention(q, *deq, 1, pv, table, P,
                                                   kv_mul, plan=plan)
        assert torch.equal(a, b), pos
        assert torch.equal(a, paged_attention.paged_decode_attention_q8(
            q, *planes, 1, pv, table, P, kv_mul, plan=plan)), pos
        _no_tickets()


@pytest.mark.parametrize("pages", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("width", PAGED_WIDTHS)
@pytest.mark.parametrize("t_len", [4, 8, 16, 39])
@pytest.mark.parametrize("plan", [None, (32, 64)])
def test_paged_split_windows_match_plain(gen, pages, width, t_len, plan):
    """K6w and K7w at t_len 4 and 8 (verify windows) and 16 and 39 (mixed
    windows: 39 is the auto budget at 8 slots and chunk 32) at a long
    prefix, split across the grid: within KERNEL_ATOL of plain, with
    windows running past the virtual plane (the budget-edge clamp: the
    last queries see the same keys)."""
    n_kv, kv_mul = width
    cache = torch.bfloat16 if pages == "bf16" else torch.float32
    _, _, _, _, moved, table, P = _long_pool(gen, cache, n_kv)
    B = table.shape[0]
    if pages == "q8":
        planes = _q8_pool(*moved)
        run = paged_attention.paged_decode_attention_q8
        plain = paged_attention.paged_decode_attention_q8_plain
    else:
        planes = moved
        run = paged_attention.paged_decode_attention
        plain = paged_attention.paged_decode_attention_plain
    q = torch.randn((B, t_len, n_kv * kv_mul * 128), device="cuda",
                    generator=gen)
    pv = torch.tensor([2047 - t_len // 2, 1000, 2047], dtype=torch.int32,
                      device="cuda")
    got = run(q, *planes, 1, pv, table, P, kv_mul, plan=plan)
    want = plain(q, *planes, 1, pv, table, P, kv_mul)
    assert (got - want).abs().max().item() <= attention.KERNEL_ATOL
    assert torch.equal(got, run(q, *planes, 1, pv, table, P, kv_mul,
                                plan=plan))
    _no_tickets()


@pytest.mark.parametrize("pages", ["f32", "bf16", "q8"])
def test_paged_split_kernels_replay_from_a_graph(gen, pages):
    """K6 (f32, bf16 pages) and K7 captured in a CUDA graph over device
    positions and replayed at clocks that cross split counts: every
    replay gives the eager bits and leaves every ticket at 0."""
    n_kv, kv_mul, B = 8, 4, 3
    cache = torch.bfloat16 if pages == "bf16" else torch.float32
    _, _, _, _, moved, table, P = _long_pool(gen, cache, n_kv)
    planes = _q8_pool(*moved) if pages == "q8" else moved
    run = (paged_attention.paged_decode_attention_q8 if pages == "q8"
           else paged_attention.paged_decode_attention)
    q = torch.randn((B, 1, n_kv * kv_mul * 128), device="cuda",
                    generator=gen)
    pv = torch.tensor([5, 40, 70], dtype=torch.int32, device="cuda")
    run(q, *planes, 1, pv, table, P, kv_mul)  # eager first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run(q, *planes, 1, pv, table, P, kv_mul)
    plan = attention.decode_plan(n_kv, B, _sms())
    seen = set()
    for pos in ([0, 127, 2047], [128, 2047, 5], [1000, 129, 64],
                [2047, 256, 0], [3, 900, 1500]):
        pv.copy_(torch.tensor(pos, dtype=torch.int32))
        q.copy_(torch.randn(q.shape, device="cuda", generator=gen))
        graph.replay()
        torch.cuda.synchronize()
        replayed = out.clone()
        _no_tickets()
        assert torch.equal(replayed, run(q, *planes, 1, pv, table, P,
                                         kv_mul)), pos
        seen |= {attention.decode_splits(p + 1, plan)[0] for p in pos}
    assert 1 in seen and len(seen) > 2


# the window kernels' (K6w, K7w) shapes: the decode walk's widths, and
# each (B, clocks) with a shared 63, a shared 2047 and ragged ones
WINDOW_T_LENS = [2, 4, 8, 16, 39]


@pytest.mark.parametrize("pages", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("width", PAGED_WIDTHS)
@pytest.mark.parametrize("t_len", WINDOW_T_LENS)
@pytest.mark.parametrize("batch", [1, 8])
def test_window_kernels_match_plain(gen, pages, width, t_len, batch):
    """K6w (f32 and bf16 pages) and K7w at every window length, B 1 and
    8, clocks 63, 2047 and ragged (past the plane's edge): one launch of
    the window kernel (of K6's or K7's split walk below WINDOW_MIN_T),
    within KERNEL_ATOL of plain, the same bits on a second launch, K7w
    K6w's bits over the dequantized pool, every ticket back at 0."""
    from distributed_llama_tpu_torch.ops.quants import dequantize_q80_planes

    n_kv, kv_mul = width
    cache = torch.bfloat16 if pages == "bf16" else torch.float32
    _, _, _, _, moved, table, P = _long_pool(gen, cache, n_kv, B=batch)
    window = t_len >= paged_attention.WINDOW_MIN_T
    if pages == "q8":
        planes = _q8_pool(*moved)
        run = paged_attention.paged_decode_attention_q8
        plain = paged_attention.paged_decode_attention_q8_plain
        kernel = (paged_attention.WINDOW_KERNEL_Q8 if window
                  else paged_attention.PAGED_KERNEL_Q8)
        deq = [dequantize_q80_planes(planes[0], planes[1]).contiguous(),
               dequantize_q80_planes(planes[2], planes[3]).contiguous()]
    else:
        planes = moved
        run = paged_attention.paged_decode_attention
        plain = paged_attention.paged_decode_attention_plain
        kernel = {(False, "f32"): paged_attention.PAGED_KERNEL,
                  (False, "bf16"): paged_attention.PAGED_KERNEL_KVBF16,
                  (True, "f32"): paged_attention.WINDOW_KERNEL,
                  (True, "bf16"): paged_attention.WINDOW_KERNEL_KVBF16}[
                      window, pages]
    q = torch.randn((batch, t_len, n_kv * kv_mul * 128), device="cuda",
                    generator=gen)
    ragged = [5, 2047, 900, 63, 1500, 17, 2040, 1023][:batch]
    for pos in ([63] * batch, [2047] * batch, ragged):
        pv = torch.tensor(pos, dtype=torch.int32, device="cuda")
        before = kernel.launches
        got = run(q, *planes, 1, pv, table, P, kv_mul)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        want = plain(q, *planes, 1, pv, table, P, kv_mul)
        assert (got - want).abs().max().item() <= attention.KERNEL_ATOL, pos
        assert torch.equal(got, run(q, *planes, 1, pv, table, P, kv_mul))
        if pages == "q8":
            assert torch.equal(got, paged_attention.paged_decode_attention(
                q, *deq, 1, pv, table, P, kv_mul)), pos
        _no_tickets()


@pytest.mark.parametrize("pages", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("t_len", [4, 39])
def test_window_kernels_replay_from_a_graph(gen, pages, t_len):
    """K6w and K7w captured in a CUDA graph over device positions (a
    verify window of 4, a mixed one of 39) and replayed at clocks that
    cross their plan's split counts: every replay gives the eager bits
    and leaves every ticket at 0."""
    n_kv, kv_mul, B = 8, 4, 1
    cache = torch.bfloat16 if pages == "bf16" else torch.float32
    _, _, _, _, moved, table, P = _long_pool(gen, cache, n_kv, B=B)
    planes = _q8_pool(*moved) if pages == "q8" else moved
    run = (paged_attention.paged_decode_attention_q8 if pages == "q8"
           else paged_attention.paged_decode_attention)
    q = torch.randn((B, t_len, n_kv * kv_mul * 128), device="cuda",
                    generator=gen)
    pv = torch.tensor([5], dtype=torch.int32, device="cuda")
    run(q, *planes, 1, pv, table, P, kv_mul)  # eager first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run(q, *planes, 1, pv, table, P, kv_mul)
    plan = paged_attention.window_plan(n_kv, B, t_len, kv_mul, _sms())
    seen = set()
    for p in (0, 127, 2047, 300, 1000, 64, 2040):
        pv.copy_(torch.tensor([p], dtype=torch.int32))
        q.copy_(torch.randn(q.shape, device="cuda", generator=gen))
        graph.replay()
        torch.cuda.synchronize()
        replayed = out.clone()
        _no_tickets()
        assert torch.equal(replayed, run(q, *planes, 1, pv, table, P,
                                         kv_mul)), p
        seen.add(paged_attention.window_splits(min(p + t_len - 1, 2047) + 1,
                                               plan)[0])
    assert 1 in seen and len(seen) > 2


def test_paged_kernels_raise_instead_of_falling_back(gen):
    k4, v4 = _paged_pool(gen, 2, 5, 4, 2, 64)
    table = torch.ones((2, 4), dtype=torch.int32, device="cuda")
    q = torch.randn((2, 1, 128), device="cuda", generator=gen)
    pv = torch.tensor([3, 4], dtype=torch.int32, device="cuda")
    run = paged_attention.paged_decode_attention
    with pytest.raises(ValueError, match="int32"):
        run(q, k4, v4, 0, pv.long(), table, 5, 1)
    with pytest.raises(ValueError, match="table"):
        run(q, k4, v4, 0, pv, table.long(), 5, 1)
    with pytest.raises(ValueError, match="out of range"):
        run(q, k4, v4, 2, pv, table, 5, 1)
    with pytest.raises(ValueError, match="t_len"):  # past grid y
        run(torch.randn((2, 32768, 128), device="cuda"), k4, v4, 0, pv,
            table, 5, 1)
    with pytest.raises(ValueError, match="kv_mul"):
        run(torch.randn((2, 1, 384), device="cuda"), k4, v4, 0, pv, table,
            5, 3)
    with pytest.raises(ValueError, match="on cuda"):
        run(q, k4.cpu(), v4.cpu(), 0, pv, table, 5, 1)
    kq4, kd4, vq4, vd4 = _q8_pool(k4, v4)
    with pytest.raises(ValueError, match="Q8 pages"):
        paged_attention.paged_decode_attention_q8(
            q, kq4, kd4.float(), vq4, vd4, 0, pv, table, 5, 1)


@pytest.mark.parametrize("pages", ["f32", "bf16", "q8"])
def test_forward_batch_paged_kernels_match_plain_and_count_launches(gen,
                                                                    pages):
    spec = _small_spec()
    params = llama.params_to_device(synth_params(spec, q40=True, seed=5),
                                    "cuda")
    kern = llama.Llama(spec, params)
    plain = llama.Llama(spec, params, llama.PLAIN)
    ps, B, L = 8, 3, spec.n_layers
    n_pages = 1 + B * spec.seq_len // ps
    dtype = torch.bfloat16 if pages == "bf16" else torch.float32

    def pool():
        if pages == "q8":
            return llama.init_cache_paged_q8(spec, n_pages, ps, "cuda")
        return llama.init_cache_paged(spec, n_pages, ps, "cuda", dtype)

    ck, cp = pool(), pool()
    table = _scrambled(B, spec.seq_len // ps, n_pages, seed=1)
    symbol = {"f32": "paged_attention", "bf16": "paged_attention_kvbf16",
              "q8": "paged_attention_q8"}[pages]
    rtol = llama.LOGIT_RTOL if pages == "f32" else llama.FAST_RTOL
    with torch.inference_mode():
        for step, pos in enumerate(([0, 0, 0], [1, 1, 1], [2, 9, 40])):
            tokens = torch.tensor([1 + step, 40, 299], device="cuda")
            pv = torch.tensor(pos, dtype=torch.int32, device="cuda")
            before = {k: k.launches for k in (*q40.KERNELS,
                                              *attention.KERNELS,
                                              *paged_attention.KERNELS)}
            a = kern.forward_batch_paged(ck, tokens, pv, table)
            assert _deltas(before) == {"q40_matvec_multi": 4 * L + 1,
                                       symbol: L}
            b = plain.forward_batch_paged(cp, tokens, pv, table)
            assert torch.isfinite(a).all()
            err = (a - b).abs().max().item()
            assert err <= rtol * b.abs().max().item(), (step, err)


ENGINE_CASES = {  # label -> engine options
    "contiguous": {},
    "paged": {"page_size": 8},
    "paged-bf16": {"page_size": 8, "cache_dtype": torch.bfloat16},
    "paged-q8": {"page_size": 8, "kv_quant": "q8"},
    "paged-q8-oversubscribed": {"page_size": 8, "kv_quant": "q8",
                                "kv_pages": 10},
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
@pytest.mark.parametrize("block", [1, 4])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_captured_continuous_engine_matches_eager(gen, case, block,
                                                  temperature):
    """The continuous engine with its steps captured and replayed, and
    eagerly, on the same model and requests: equal streams (admission
    prefill at chunk 4 runs between replays and writes the captured pool in
    place), equal allocator counters, clean audits and exact launch counts:
    K6/K7 (or K5) L per device step, the warm-ups and replays of every
    graph together making all the steps."""
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine

    spec = _small_spec()
    params = llama.params_to_device(synth_params(spec, q40=True, seed=5,
                                                 scale=0.3), "cuda")
    rng = np.random.default_rng(7)
    prefix = [1, *rng.integers(3, spec.vocab_size, 15)]
    reqs = [prefix + list(rng.integers(3, spec.vocab_size, n))
            for n in (2, 9, 4, 12, 1, 6)]
    opts = ENGINE_CASES[case]
    kernels = (*q40.KERNELS, *attention.KERNELS, *paged_attention.KERNELS)
    res = {}
    for graph in (True, False):
        eng = ContinuousEngine(spec, params, 3, temperature, 0.9, 11,
                               prefill_chunk=4, block_steps=block,
                               device="cuda", graph=graph, **opts)
        before = {k: k.launches for k in kernels}
        outs, stats = eng.run(reqs, 40)
        torch.cuda.synchronize()
        a = eng.allocator
        res[graph] = (outs, _deltas(before), stats.steps, eng.audit_pages(),
                      None if a is None else (a.prefix_hits, a.tokens_saved,
                                              a.evictions),
                      eng.graph_replays)
    (g_out, g_counts, g_steps, g_audit, g_alloc, replays), \
        (e_out, e_counts, e_steps, e_audit, e_alloc, _) = res[True], res[False]
    assert g_out == e_out and sum(len(r) for r in g_out) > 40
    assert g_steps == e_steps and g_alloc == e_alloc
    assert g_audit == e_audit == []
    assert g_counts == e_counts
    symbol = ("decode_attention_batch" if "page_size" not in opts else
              "paged_attention_q8" if "kv_quant" in opts else
              "paged_attention_kvbf16" if "cache_dtype" in opts else
              "paged_attention")
    assert g_counts[symbol] == spec.n_layers * g_steps
    assert replays + 1 == g_steps  # one graph: its warm-up, then replays


WINDOW_CASES = {  # label -> engine options of a window dispatch
    "verify": {"spec_k": 4},
    "verify-q8": {"spec_k": 4, "kv_quant": "q8"},
    "mixed": {"dispatch_tokens": 7},
    "mixed-bf16": {"dispatch_tokens": 7, "cache_dtype": torch.bfloat16},
}


def _window_requests(spec):
    rng = np.random.default_rng(7)
    prefix = [1, *rng.integers(3, spec.vocab_size, 15)]
    phrase = list(rng.integers(3, spec.vocab_size, 3))
    return [prefix + phrase * r + list(rng.integers(3, spec.vocab_size, n))
            for r, n in ((2, 2), (0, 9), (3, 4), (1, 12), (0, 1), (2, 6))]


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_captured_window_dispatch_is_the_eager_one(gen, case, temperature):
    """A verify or mixed dispatch captured in a CUDA graph and replayed, and
    the same engine run eagerly, side by side: after every dispatch the
    window's output (the device argmax, or the logits when sampled) at
    every live (row, offset) is the eager one's bit for bit, the streams
    and page state equal, K6w/K7w L launches a dispatch (the window
    kernels: both widths are WINDOW_MIN_T or more), the audits clean.
    Live: an active row's offsets below its span (mixed) or below its
    budget (verify). The rest is junk the host never reads: it attends
    over the scrap page, whose dead writes of one dispatch land in no
    fixed order."""
    from distributed_llama_tpu_torch.runtime.continuous import (
        ContinuousEngine, Request)

    spec = _small_spec()
    params = llama.params_to_device(synth_params(spec, q40=True, seed=5,
                                                 scale=0.3), "cuda")
    opts = WINDOW_CASES[case]
    kind = "verify" if "spec_k" in opts else "mixed"
    engines = [ContinuousEngine(spec, params, 3, temperature, 0.9, 11,
                                prefill_chunk=4, page_size=8, device="cuda",
                                graph=graph, **opts)
               for graph in (True, False)]
    reqs = [[eng.submit(Request(tokens=list(r), steps=40))
             for r in _window_requests(spec)] for eng in engines]
    width = opts.get("spec_k") or opts["dispatch_tokens"]
    assert width >= paged_attention.WINDOW_MIN_T
    symbol = ("paged_window_q8" if "kv_quant" in opts else
              "paged_window_kvbf16" if "cache_dtype" in opts else
              "paged_window")
    kernels = (*q40.KERNELS, *attention.KERNELS, *paged_attention.KERNELS)
    dispatches = 0
    budgets = []  # each slot's budget when the window ran
    run = engines[0]._run_window

    def recorded(*args):
        budgets[:] = [s.budget for s in engines[0]._pool]
        return run(*args)

    engines[0]._run_window = recorded
    while True:
        left = []
        for eng in engines:
            before = {k: k.launches for k in kernels}
            left.append(eng.step_many(1))
            torch.cuda.synchronize()
            assert _deltas(before).get(symbol, 0) == spec.n_layers
        dispatches += 1
        eng = engines[0]
        cols = np.arange(width)[None, :]
        if kind == "verify":
            live = (eng._stage_active[:, None]
                    & (eng._stage_i32[1][:, None] + cols
                       < np.array(budgets)[:, None]))
        else:
            live = cols < eng._stage_i32[0][:, None]
        live = torch.from_numpy(live).to("cuda")
        key = (kind, temperature == 0.0)
        a, b = (e._windows[key].out for e in engines)
        assert live.any() and torch.equal(a[live], b[live]), dispatches
        assert left[0] == left[1]
        assert [s.pages for s in engines[0]._pool] == \
            [s.pages for s in engines[1]._pool]
        if not left[0]:
            break
    assert [r.out for r in reqs[0]] == [r.out for r in reqs[1]]
    assert engines[0].graph_replays + 1 == dispatches
    assert all(eng.audit_pages() == [] for eng in engines)
    st = engines[0].stats
    if kind == "verify":
        assert st.spec_proposed > 0
    else:
        assert st.prefill_chunks == 0


def _recording_sampler(gaps):
    """A Sampler whose every host sample records the gap of its logits'
    two largest values and their largest |value|, by seed."""
    from distributed_llama_tpu_torch.runtime.sampling import Sampler

    class Recording(Sampler):
        def __init__(self, vocab_size, temperature, topp, seed):
            super().__init__(vocab_size, temperature, topp, seed)
            self.gaps = gaps.setdefault(seed, [])

        def sample(self, logits):
            top = np.sort(np.asarray(logits, np.float32))[-2:]
            self.gaps.append((float(top[1] - top[0]),
                              float(np.abs(logits).max())))
            return super().sample(logits)

    return Recording


@pytest.mark.parametrize("kv_quant", ["f32", "q8"])
def test_spec_engine_greedy_streams_equal_spec_off(gen, kv_quant,
                                                   monkeypatch):
    """ContinuousEngine(spec_k=4) greedy against spec_k=0 on the card:
    every stream equal, or parting only where the spec-off run's top-2
    logits lie within LOGIT_RTOL x max|logit| (the verify rows take K3 at
    B*K = 12 rows where decode takes K1m at 3: their sums differ in the
    last bits); drafts accepted (random Q40 codes: the greedy streams
    settle into short cycles the drafter copies)."""
    from distributed_llama_tpu_torch.models.synth import synth_q40_fast
    from distributed_llama_tpu_torch.runtime import continuous

    spec = _small_spec()
    params = llama.params_to_device(synth_q40_fast(spec, seed=5), "cuda")
    reqs = _window_requests(spec)
    gaps: dict = {}
    runs = {}
    for k in (0, 4):
        if k == 0:
            monkeypatch.setattr(continuous, "Sampler",
                                _recording_sampler(gaps))
        eng = continuous.ContinuousEngine(
            spec, params, 3, 0.0, 0.9, 11, page_size=8, kv_quant=kv_quant,
            spec_k=k, device="cuda")
        runs[k] = eng.run(reqs, 40)
        monkeypatch.undo()
    (off, _), (on, st) = runs[0], runs[4]
    assert st.spec_accepted > 0
    for i, (a, b, r) in enumerate(zip(on, off, reqs)):
        if a == b:
            continue
        j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        gap, top = gaps[11 + i][j - (len(r) - 1)]
        assert gap <= llama.LOGIT_RTOL * top, (i, j, gap, top)


# ---------------------------------------------------------------------------
# the fused decode layer: K8 (head), K9 (tail), K10 (whole layer)
# ---------------------------------------------------------------------------

from distributed_llama_tpu_torch.ops import layer  # noqa: E402

# (dim, hidden_dim, n_heads, n_kv_heads): MHA at head size 128, GQA at
# kv_mul 2, 4 and 8, and hidden widths whose staged hb needs more than 48
# KB of shared memory (7B's) and fits one block per SM (70B's), run after
# narrower ones: the co-resident grid is sized per shared-memory size
FUSED_SHAPES = [(256, 704, 2, 2), (512, 1376, 8, 4), (512, 1376, 8, 2),
                (1024, 2816, 8, 1), (256, 11008, 2, 2), (256, 28672, 2, 2)]
FUSED_SEQ = 64


def _fused_inputs(gen, dim, hid, n_heads, n_kv, cache=torch.float32):
    lw = layer.random_layer(dim, hid, n_heads, n_kv, "cuda", gen)
    x = torch.randn((1, dim), device="cuda", generator=gen)
    hs = dim // n_heads
    shape = (2, FUSED_SEQ, n_kv, hs)
    k = torch.randn(shape, device="cuda", generator=gen).to(cache)
    v = torch.randn(shape, device="cuda", generator=gen).to(cache)
    return lw, x, k, v


def _close(got, want, rtol=q40.KERNEL_RTOL):
    err = (got - want).abs().max().item()
    assert err <= rtol * want.abs().max().item(), err


@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("pos", [0, 5, 63])
def test_fused_head_kernel_matches_plain(gen, shape, pos):
    lw, x, _, _ = _fused_inputs(gen, *shape)
    p = torch.tensor([pos], dtype=torch.int32, device="cuda")
    before = layer.HEAD_KERNEL.launches
    got = layer.q40_head_fused(x, lw["wqkv"], lw["rms_att"], lw["freq"], p)
    assert layer.HEAD_KERNEL.launches == before + 1
    want = layer.q40_head_fused_plain(x, lw["wqkv"], lw["rms_att"],
                                      lw["freq"], p)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_tail_kernel_matches_plain_and_k1_bits(gen, shape):
    """K9 against plain; and its wo and w2 rows give the classic row body's
    bits (the Q40 layout probe's P0, K1's body before its tensor-core
    redesign): the scratch xnew is x + P0(wo, ao), the output
    xnew + P0(w2, hb), bit for bit."""
    from distributed_llama_tpu_torch.tools import nb_probe

    lw, x, _, _ = _fused_inputs(gen, *shape)
    ao = torch.randn(x.shape, device="cuda", generator=gen)
    before = layer.TAIL_KERNEL.launches
    got = layer.q40_tail_fused(ao, x, lw["wo"], lw["w13"], lw["w2"],
                               lw["rms_ffn"])
    assert layer.TAIL_KERNEL.launches == before + 1
    _close(got, layer.q40_tail_fused_plain(ao, x, lw["wo"], lw["w13"],
                                           lw["w2"], lw["rms_ffn"]))
    s = layer._scratch(x.device, shape[0], shape[1])
    torch.testing.assert_close(
        s.xnew[None], x + nb_probe.probe_classic(lw["wo"], ao[0])[None],
        rtol=0, atol=0)
    torch.testing.assert_close(got, s.xnew[None] + nb_probe.probe_classic(
        lw["w2"], s.hb.clone())[None], rtol=0, atol=0)
    assert s.bar[0].item() == 0  # the barrier leaves its count at 0


@pytest.mark.parametrize("shape", FUSED_SHAPES[:4])
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 7, 63])
def test_fused_mega_kernel_matches_plain(gen, shape, cache, pos):
    """K10 against plain, part by part: the head (q in the scratch, k and v
    written at (layer 1, pos)) within the Q40 tolerance (one bf16 step on
    a bf16 cache), the attention over the cache it wrote against the plain
    attention of its own q within the attention tolerance (1e-5 abs), the
    tail from its own attention output within the Q40 tolerance, and the
    layer output against the plain layer (a bf16 cache within 1e-3 of the
    largest |value|: a k/v value the two round across a bf16 boundary
    moves the scores). Rows of the cache other than (1, pos) stay."""
    dim, hid, n_heads, n_kv = shape
    hs = dim // n_heads
    lw, x, k, v = _fused_inputs(gen, *shape, cache=cache)
    kp, vp = k.clone(), v.clone()
    p = torch.tensor([pos], dtype=torch.int32, device="cuda")
    args = (lw["wqkv"], lw["wo"], lw["w13"], lw["w2"], lw["rms_att"],
            lw["rms_ffn"], lw["freq"])
    before = layer.MEGA_KERNEL.launches
    got = layer.q40_layer_mega(x, *args, k, v, 1, p, n_heads // n_kv)
    assert layer.MEGA_KERNEL.launches == before + 1
    want = layer.q40_layer_mega_plain(x, *args, kp, vp, 1, p,
                                      n_heads // n_kv)
    s = layer._scratch(x.device, dim, hid)
    head = layer.q40_head_fused_plain(x, lw["wqkv"], lw["rms_att"],
                                      lw["freq"], p)[0]
    _close(s.q, head[:dim])
    kv_dim = n_kv * hs
    step = 2.0 ** -7 if cache == torch.bfloat16 else q40.KERNEL_RTOL
    _close(k[1, pos].float().reshape(-1), head[dim:dim + kv_dim], step)
    _close(v[1, pos].float().reshape(-1), head[dim + kv_dim:], step)
    ao = attention.decode_attention_plain(s.q.reshape(-1, hs), k, v, 1, pos,
                                          n_heads // n_kv)
    assert (s.ao[None] - ao).abs().max().item() <= attention.KERNEL_ATOL
    _close(got, layer.q40_tail_fused_plain(s.ao[None].clone(), x, lw["wo"],
                                           lw["w13"], lw["w2"],
                                           lw["rms_ffn"]))
    _close(got, want, 1e-3 if cache == torch.bfloat16 else q40.KERNEL_RTOL)
    keep = torch.ones(k.shape[:2], dtype=torch.bool, device="cuda")
    keep[1, pos] = False
    assert torch.equal(k[keep], kp[keep]) and torch.equal(v[keep], vp[keep])


# K10 at full width: Llama-2-7B's layer and the GQA case at 70B's widths
# (n_kv 8, kv_mul 8), a seq_len 2048 cache, pos 0, 1, 63 and 2047 (the
# attention in 1, 2 and up to MEGA_MAX_SPLITS key splits per kv head)
MEGA_CASES = {"7b": (4096, 11008, 32, 32), "gqa8": (8192, 28672, 64, 8)}


@pytest.mark.parametrize("case", sorted(MEGA_CASES))
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
def test_fused_mega_kernel_at_full_width(gen, case, cache):
    """K10 against plain part by part at every pos (the tolerances of
    test_fused_mega_kernel_matches_plain), its wo and w2 rows with the
    classic row body's bits (P0: xnew = x + P0(wo, ao), out = xnew +
    P0(w2, hb), bit for bit, the first blocks of each row loaded ahead of
    the barrier), and the barrier's arrival count and the split tickets
    back at 0."""
    from distributed_llama_tpu_torch.tools import nb_probe

    dim, hid, n_heads, n_kv = MEGA_CASES[case]
    hs, kv_mul = dim // n_heads, n_heads // n_kv
    lw = layer.random_layer(dim, hid, n_heads, n_kv, "cuda", gen)
    x = torch.randn((1, dim), device="cuda", generator=gen)
    shape = (2, 2048, n_kv, hs)
    k = torch.randn(shape, device="cuda", generator=gen).to(cache)
    v = torch.randn(shape, device="cuda", generator=gen).to(cache)
    args = (lw["wqkv"], lw["wo"], lw["w13"], lw["w2"], lw["rms_att"],
            lw["rms_ffn"], lw["freq"])
    s = layer._scratch(x.device, dim, hid)
    for pos in (0, 1, 63, 2047):
        p = torch.tensor([pos], dtype=torch.int32, device="cuda")
        kp, vp = k.clone(), v.clone()
        got = layer.q40_layer_mega(x, *args, k, v, 1, p, kv_mul)
        want = layer.q40_layer_mega_plain(x, *args, kp, vp, 1, p, kv_mul)
        ao = attention.decode_attention_plain(s.q.reshape(-1, hs), k, v, 1,
                                              pos, kv_mul)
        assert (s.ao[None] - ao).abs().max().item() <= attention.KERNEL_ATOL
        _close(got, layer.q40_tail_fused_plain(
            s.ao[None].clone(), x, lw["wo"], lw["w13"], lw["w2"],
            lw["rms_ffn"]))
        _close(got, want, 1e-3 if cache == torch.bfloat16
               else q40.KERNEL_RTOL)
        torch.testing.assert_close(
            s.xnew[None], x + nb_probe.probe_classic(lw["wo"],
                                                     s.ao.clone())[None],
            rtol=0, atol=0)
        torch.testing.assert_close(got, s.xnew[None] + nb_probe.probe_classic(
            lw["w2"], s.hb.clone())[None], rtol=0, atol=0)
        # the barrier's arrival count and every split ticket back at 0
        assert s.bar[0].item() == 0 and not s.tickets.any(), pos
        k.copy_(kp)  # the plain write, bf16 rounding and all
        v.copy_(vp)


def test_fused_mega_kernel_replays_from_a_graph(gen):
    """K10 captured in a CUDA graph (device pos, static scratch) and
    replayed at positions whose attention takes 1, 2, 8 and 3 key splits:
    every replay gives the eager bits and leaves the barrier's arrival
    count and the split tickets at 0."""
    dim, hid, n_heads, n_kv = MEGA_CASES["7b"]
    lw = layer.random_layer(dim, hid, n_heads, n_kv, "cuda", gen)
    x = torch.randn((1, dim), device="cuda", generator=gen)
    shape = (2, 2048, n_kv, dim // n_heads)
    k = torch.randn(shape, device="cuda", generator=gen)
    v = torch.randn(shape, device="cuda", generator=gen)
    args = (lw["wqkv"], lw["wo"], lw["w13"], lw["w2"], lw["rms_att"],
            lw["rms_ffn"], lw["freq"])
    p = torch.tensor([5], dtype=torch.int32, device="cuda")
    layer.q40_layer_mega(x, *args, k, v, 1, p, 1)  # eager: scratch, grid
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = layer.q40_layer_mega(x, *args, k, v, 1, p, 1)
    s = layer._scratch(x.device, dim, hid)
    for pos in (0, 200, 2047, 300):
        p.fill_(pos)
        x.copy_(torch.randn((1, dim), device="cuda", generator=gen))
        graph.replay()
        torch.cuda.synchronize()
        replayed = out.clone()
        assert s.bar[0].item() == 0 and not s.tickets.any(), pos
        assert torch.equal(replayed,
                           layer.q40_layer_mega(x, *args, k, v, 1, p, 1))


def test_profiler_sessions_each_hold_exactly_their_launches(gen, tmp_path):
    """Six obs/profiler.trace sessions in one process, each around a known
    number of K1 launches at a small shape (the count varied from session
    to session): each trace holds exactly its session's launches, counted
    as tools/nb_probe counts them (utils/it_split.parse_trace,
    DeviceSplit.counts by base name)."""
    from distributed_llama_tpu_torch.obs import profiler
    from distributed_llama_tpu_torch.utils import it_split

    w = q40.random_q40(256, 1024, "cuda", gen)
    x = torch.randn((1, 1024), device="cuda", generator=gen)
    q40.q40_matmul(w, x)
    torch.cuda.synchronize()
    for i, n in enumerate((32, 7, 1, 64, 16, 3)):
        where = str(tmp_path / f"s{i}")
        before = q40.KERNEL.launches
        with profiler.trace(where, cuda=True):
            for _ in range(n):
                q40.q40_matmul(w, x)
        assert q40.KERNEL.launches == before + n
        splits = it_split.parse_trace(where)
        events = sum(s.counts["q40_matvec_kernel"] for s in splits.values())
        assert events == n, (i, events, n)


def test_fused_kernels_raise_instead_of_falling_back(gen):
    lw, x, k, v = _fused_inputs(gen, 256, 704, 2, 2)
    p = torch.tensor([3], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="pos must be one int32"):
        layer.q40_head_fused(x, lw["wqkv"], lw["rms_att"], lw["freq"],
                             p.long())
    with pytest.raises(ValueError, match="contiguous on cuda"):
        layer.q40_head_fused(x, Q40Weight(lw["wqkv"].qs.cpu(),
                                          lw["wqkv"].d16),
                             lw["rms_att"], lw["freq"], p)
    with pytest.raises(ValueError, match="do not fit a layer"):
        layer.q40_tail_fused(x, x, lw["wo"], lw["w13"], lw["wo"],
                             lw["rms_ffn"])
    with pytest.raises(ValueError, match="kv_mul"):
        layer.q40_layer_mega(x, lw["wqkv"], lw["wo"], lw["w13"], lw["w2"],
                             lw["rms_att"], lw["rms_ffn"], lw["freq"], k, v,
                             0, p, 3)
    with pytest.raises(ValueError, match="caches must be equal"):
        layer.q40_layer_mega(x, lw["wqkv"], lw["wo"], lw["w13"], lw["w2"],
                             lw["rms_att"], lw["rms_ffn"], lw["freq"], k,
                             v.to(torch.bfloat16), 0, p, 1)
    with pytest.raises(ValueError, match="no kernel for device"):
        layer.q40_tail_fused(x.cpu(), x.cpu(), lw["wo"], lw["w13"],
                             lw["w2"], lw["rms_ffn"].cpu())


FUSED_KERNELS = (*q40.KERNELS, *attention.KERNELS, *layer.KERNELS)


@pytest.mark.parametrize("mode", ["headtail", "on"])
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
def test_fused_forward_counts_launches_and_matches(gen, mode, cache):
    """Llama.forward under a fused mode on the card: per step 'headtail'
    launches L K8, L K2, L K9 and one K1 (wcls), 'on' L K10 and one K1,
    nothing else; logits within LOGIT_RTOL of the plain fused route and of
    the unfused kernels (FAST_RTOL over a bf16 cache, which rounds where
    the two sum apart)."""
    spec = _small_spec(seq_len=64) if mode == "headtail" else TransformerSpec(
        dim=512, hidden_dim=1376, n_layers=2, n_heads=4, n_kv_heads=2,
        vocab_size=300, seq_len=64, weights_float_type=FloatType.Q40)
    params = llama.params_to_device(synth_params(spec, q40=True, seed=5,
                                                 scale=0.3), "cuda")
    kern = llama.Llama(spec, params, fusion=mode)
    plain = llama.Llama(spec, params, llama.PLAIN, fusion=mode)
    unfused = llama.Llama(spec, params)
    assert kern.fusion == mode
    caches = [llama.init_cache(spec, "cuda", cache) for _ in range(3)]
    L = spec.n_layers
    want_counts = ({"q40_head_fused": L, "decode_attention" + (
        "_kvbf16" if cache == torch.bfloat16 else ""): L,
        "q40_tail_fused": L, "q40_matvec": 1} if mode == "headtail" else
        {"q40_layer_mega": L, "q40_matvec": 1})
    rtol = llama.LOGIT_RTOL if cache == torch.float32 else llama.FAST_RTOL
    with torch.inference_mode():
        for pos, tok in enumerate([1, 40, 7, 299, 3]):
            before = {k: k.launches for k in FUSED_KERNELS}
            a = kern(caches[0], tok, pos)
            assert _deltas(before) == want_counts
            b = plain(caches[1], tok, pos)
            c = unfused(caches[2], tok, pos)
            assert torch.isfinite(a).all()
            for ref in (b, c):
                err = (a - ref).abs().max().item()
                assert err <= rtol * ref.abs().max().item(), (pos, err)


@pytest.mark.parametrize("mode", ["headtail", "on"])
def test_captured_fused_loop_matches_eager_and_host(gen, mode):
    """generate_fast under a fused mode, the step captured and eagerly,
    against generate on the same engine: equal greedy streams. The
    captured run launches, per step run, L K10 and one K1 ('on') or L K8,
    L K5, L K9 and one K1 ('headtail'), never K2."""
    import os

    from distributed_llama_tpu_torch.runtime.generate import (generate,
                                                              generate_fast)
    from distributed_llama_tpu_torch.runtime.sampling import Sampler

    class Tok:  # ids as pieces: the prompt is 1, 9, 40
        def encode(self, text, bos=True, eos=False):
            return [1, 9, 40]

        def decode_piece(self, prev, tok):
            return b"."

    spec = TransformerSpec(dim=512, hidden_dim=1376, n_layers=2, n_heads=4,
                           n_kv_heads=2, vocab_size=300, seq_len=48,
                           weights_float_type=FloatType.Q40)
    saved = os.environ.get("DLLAMA_LAYER_FUSION")
    os.environ["DLLAMA_LAYER_FUSION"] = mode
    try:
        engine = Engine(spec, synth_params(spec, q40=True, seed=5,
                                           scale=0.3), "cuda")
    finally:
        if saved is None:
            os.environ.pop("DLLAMA_LAYER_FUSION")
        else:
            os.environ["DLLAMA_LAYER_FUSION"] = saved
    assert engine.model.fusion == mode
    streams, launches = {}, {}
    for label, run, kw in (("host", generate, {}),
                           ("graph", generate_fast, {"graph": True}),
                           ("eager", generate_fast, {"graph": False})):
        engine.reset()
        before = {k: k.launches for k in FUSED_KERNELS}
        streams[label], _ = run(engine, Tok(), Sampler(300, 0.0, 0.9, 3),
                                "", 30, quiet=True, **kw)
        launches[label] = _deltas(before)
    assert streams["graph"] == streams["eager"] == streams["host"]
    assert len(streams["host"]) > 20
    L = spec.n_layers
    ran = engine.decode_loop(0.0, 0.9, True).replays + 1
    want = ({"q40_layer_mega": L * ran} if mode == "on" else
            {"q40_head_fused": L * ran, "decode_attention_batch": L * ran,
             "q40_tail_fused": L * ran})
    assert launches["graph"] == {"q40_matvec": ran, **want}


# ---------------------------------------------------------------------------
# B10: the Q40 layout probe's kernels (P1-P4; P2 and P4 on K1's skeleton,
# with K1's bits), the traced chain, and --profile / --save-state /
# --resume-state on the card
# ---------------------------------------------------------------------------

from distributed_llama_tpu_torch.tools import nb_probe  # noqa: E402

# tiny, ragged block counts (nb 2, 37: off the 32 lanes and the unroll),
# rows off the 8-row blocks, and the 13B shapes the probe times
PROBE_SHAPES = [(256, 256), (7, 64), (40, 32 * 37), (33, 32 * 129),
                (27648, 5120), (15360, 5120), (5120, 5120)]


def _probe_case(variant, w, x):
    """(kernel call, plain call, kernel, tolerance factor)."""
    if variant == "v0":
        return (lambda: nb_probe.probe_classic(w, x),
                lambda: nb_probe.probe_xglobal_plain(w, x), nb_probe.CLASSIC,
                nb_probe.KERNEL_RTOL)
    if variant == "dma":
        return (lambda: nb_probe.probe_stream(w),
                lambda: nb_probe.probe_stream_plain(w), nb_probe.STREAM,
                nb_probe.KERNEL_RTOL)
    if variant == "v0r":
        return (lambda: nb_probe.probe_xglobal(w, x),
                lambda: nb_probe.probe_xglobal_plain(w, x), nb_probe.XGLOBAL,
                nb_probe.KERNEL_RTOL)
    if variant == "v1":
        xp = nb_probe.prep_nomask(x)
        return (lambda: nb_probe.probe_nomask(w, xp),
                lambda: nb_probe.probe_nomask_plain(w, xp), nb_probe.NOMASK,
                nb_probe.KERNEL_RTOL_NOMASK)
    ws = Q40Weight(nb_probe.to_signed(w.qs), w.d16)
    return (lambda: nb_probe.probe_signed(ws, x),
            lambda: nb_probe.probe_signed_plain(ws, x), nb_probe.SIGNED,
            nb_probe.KERNEL_RTOL)


@pytest.mark.parametrize("variant", ["v0", "dma", "v0r", "v1", "i4"])
@pytest.mark.parametrize("d,n", PROBE_SHAPES)
def test_probe_kernels_match_plain(gen, variant, d, n):
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((n,), device="cuda", generator=gen)
    run, plain, kernel, rtol = _probe_case(variant, w, x)
    before = kernel.launches
    got = run()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain()
    assert got.shape == want.shape == (d,)
    err = (got - want).abs().max().item()
    assert err <= rtol * want.abs().max().item(), err


def test_probe_kernels_raise_instead_of_falling_back(gen):
    """P3 stages x whole and refuses a width past shared memory; P4, on
    K1's skeleton, splits K at that width as K1 does and gives its bits.
    Inputs the kernels do not take raise."""
    w = q40.random_q40(8, 32 * 2048, "cuda", gen)  # staged x: 295 KB
    x = torch.randn((32 * 2048,), device="cuda", generator=gen)
    with pytest.raises(ValueError, match="staging"):
        nb_probe.probe_nomask(w, nb_probe.prep_nomask(x))
    ws = Q40Weight(nb_probe.to_signed(w.qs), w.d16)
    assert torch.equal(nb_probe.probe_signed(ws, x),
                       q40.q40_matmul(w, x[None])[0])
    w = q40.random_q40(8, 64, "cuda", gen)
    with pytest.raises(ValueError, match="float32"):
        nb_probe.probe_signed(w, torch.zeros(64, device="cuda",
                                             dtype=torch.float64))
    with pytest.raises(ValueError, match="aligned"):
        nb_probe.probe_signed(w, torch.zeros(65, device="cuda")[1:])
    with pytest.raises(ValueError, match="float32"):
        nb_probe.probe_xglobal(w, torch.zeros(64, device="cuda",
                                              dtype=torch.float64))
    xlaid = nb_probe.lay_x(torch.zeros(64, device="cuda"))
    with pytest.raises(ValueError, match="lay_x"):
        nb_probe.probe_xglobal_laid(w, xlaid.to(torch.float32))
    with pytest.raises(ValueError, match="lay_x"):
        nb_probe.probe_xglobal_laid(w, xlaid[:1])


def _k1_skeleton_case(variant, w, x):
    """(P2 or P4 call, its kernel) on K1's weight w and x."""
    if variant == "v0r":
        return lambda: nb_probe.probe_xglobal(w, x), nb_probe.XGLOBAL
    ws = Q40Weight(nb_probe.to_signed(w.qs), w.d16)
    return lambda: nb_probe.probe_signed(ws, x), nb_probe.SIGNED


@pytest.mark.parametrize("variant", ["v0r", "i4"])
@pytest.mark.parametrize("d,n", PROBE_SHAPES)
def test_probe_k1_skeleton_kernels_give_k1_bits(gen, variant, d, n):
    """P2 (x pre-laid) and P4 (signed codes) form K1's exact products in
    K1's MMA order at K1's plan: K1's bits, one launch a call, the same
    bits from a second launch, every split-K ticket back at 0."""
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((n,), device="cuda", generator=gen)
    run, kernel = _k1_skeleton_case(variant, w, x)
    before = kernel.launches
    got = run()
    again = run()
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, q40.q40_matmul(w, x[None])[0])
    assert not q40._tickets(x.device).any()


@pytest.mark.parametrize("variant", ["v0r", "i4"])
def test_probe_k1_skeleton_kernels_replay_split_k_from_a_graph(gen, variant):
    """At 70B's w2 K1's plan splits K: P2 and P4 captured in a CUDA graph
    and replayed on new x give K1's eager bits and leave every ticket at
    0 (P2's graph holds lay_x's torch ops too)."""
    d, n = 8192, 28672
    assert q40.matvec_plan(1, d, n // 32, _sms())[3] > 1
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((n,), device="cuda", generator=gen)
    run, _ = _k1_skeleton_case(variant, w, x)
    run()  # the eager first call (tickets, opt-in)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    for seed in range(3):
        x.copy_(torch.randn((n,), device="cuda", generator=gen))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, q40.q40_matmul(w, x[None])[0]), seed
        assert not q40._tickets(x.device).any()


def test_probe_main_traces_every_variant(capsys):
    """The probe's own run at the tiny shape: parity, the traced chain with
    exactly layers x reps events per variant, and a timed line each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert nb_probe.main(["--shape", "tiny", "--layers", "2", "--reps",
                          "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("card: ")
    assert len(lines) == 1 + len(nb_probe.VARIANTS)
    for line in lines[1:]:
        assert "(trace, 6 events)" in line and "GB/s" in line, line


# tensor parallelism: a 7B rank's Q40 bands at tp 2 and 4 (parallel/tp.py:
# the fused scheme's wqkv, w13 and wcls row bands and wo, w2 block bands,
# the ref scheme's wo and w2 row bands), K1 and K1m by their plans and K3
# at a prefill chunk, against plain
def _band_shapes(tp):
    return [(12288 // tp, 4096), (4096, 4096 // tp), (22016 // tp, 4096),
            (4096, 11008 // tp), (32000 // tp, 4096), (4096 // tp, 4096),
            (4096 // tp, 11008)]


@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("d,n", sorted({s for tp in (2, 4)
                                        for s in _band_shapes(tp)}))
def test_q40_matvec_kernels_match_plain_at_tp_band_shapes(gen, d, n, t):
    _matvec_case(gen, d, n, t)


@pytest.mark.parametrize("d,n", sorted({s for tp in (2, 4)
                                        for s in _band_shapes(tp)[:4]}))
def test_q40_gemm_kernel_matches_plain_at_tp_band_shapes(gen, d, n):
    w = q40.random_q40(d, n, "cuda", gen)
    x = torch.randn((16, n), device="cuda", generator=gen)
    before = q40.KERNEL_GEMM.launches
    got = q40.q40_matmul(w, x)
    torch.cuda.synchronize()
    assert q40.KERNEL_GEMM.launches == before + 1
    want = q40.q40_matmul_plain(w, x)
    err = (got - want).abs().max().item()
    assert err <= q40.KERNEL_RTOL * want.abs().max().item(), err


TP_SPEC = TransformerSpec(dim=512, hidden_dim=1024, n_layers=2, n_heads=8,
                          n_kv_heads=4, vocab_size=512, seq_len=64,
                          weights_float_type=FloatType.Q40)


def _tp_card_rank(rank, world, port, out):
    """A gloo rank on cuda:0 (its ranks share the card): a 12-token prefill
    (K3, K4 over its bands), a decode step (K1, K2) and a 5-token chunk
    (K1m), under fused and ref; rank 0 saves the logits."""
    import pickle

    import torch.distributed as dist

    from distributed_llama_tpu_torch.parallel.mesh import TPGroup
    from distributed_llama_tpu_torch.parallel.tp import (make_sharded_forward,
                                                         shard_params)

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    group = TPGroup(rank, world, dist.group.WORLD, torch.device("cuda", 0))
    got = {}
    for scheme in ("fused", "ref"):
        bands = shard_params(synth_params(TP_SPEC, True, seed=3), rank,
                             world, scheme)
        model = make_sharded_forward(TP_SPEC, bands, group, scheme)
        cache = llama.init_cache(model.spec, group.device)
        with torch.inference_mode():
            got[scheme] = [model(cache, list(range(1, 13)), 0).cpu(),
                           model(cache, 3, 12).cpu(),
                           model(cache, list(range(5)), 13).cpu()]
    if rank == 0:
        with open(out, "wb") as fh:
            pickle.dump(got, fh)
    dist.destroy_process_group()


def test_tp2_gloo_step_on_the_card_matches_tp1(gen, tmp_path):
    """Two gloo ranks sharing the card against the one-device forward
    through the same kernels: within LOGIT_RTOL x max (fused's all_reduce
    sums in another order; ref only gathers)."""
    import pickle

    import torch.multiprocessing as mp

    from distributed_llama_tpu_torch.parallel.mesh import free_port

    out = tmp_path / "tp2.pkl"
    mp.start_processes(_tp_card_rank, args=(2, free_port(), str(out)),
                       nprocs=2, start_method="spawn")
    with open(out, "rb") as fh:
        got = pickle.load(fh)
    model = llama.Llama(TP_SPEC, llama.params_to_device(
        synth_params(TP_SPEC, True, seed=3), "cuda"))
    cache = llama.init_cache(TP_SPEC, "cuda")
    with torch.inference_mode():
        want = [model(cache, list(range(1, 13)), 0).cpu(),
                model(cache, 3, 12).cpu(),
                model(cache, list(range(5)), 13).cpu()]
    for scheme, calls in got.items():
        for a, b in zip(calls, want):
            err = (a - b).abs().max().item()
            assert err <= llama.LOGIT_RTOL * b.abs().max().item(), (scheme,
                                                                    err)


SP_CALLS = [(list(range(1, 13)), 0), ([3], 12),
            (list(range(2, 22)), 13), ([7], 33)]  # crosses position 32


def _sp_card_rank(rank, world, port, out):
    """A gloo rank of sp 2 on cuda:0 (its ranks share the card): the
    SP_CALLS over the sp-sharded cache (K3 and K1 for the products, the
    LSE combine over sp in torch); rank 0 saves the logits."""
    import pickle

    import torch.distributed as dist

    from distributed_llama_tpu_torch.parallel.mesh import TPGroup
    from distributed_llama_tpu_torch.parallel.tp import make_sharded_forward

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    group = TPGroup(0, 1, None, torch.device("cuda", 0), rank, world,
                    dist.group.WORLD)
    model = make_sharded_forward(TP_SPEC, synth_params(TP_SPEC, True, seed=3),
                                 group, "fused")
    cache = llama.init_cache(model.spec, group.device)
    with torch.inference_mode():
        got = [model(cache, t, p).cpu() for t, p in SP_CALLS]
    if rank == 0:
        with open(out, "wb") as fh:
            pickle.dump(got, fh)
    dist.destroy_process_group()


def test_sp2_gloo_forward_on_the_card_matches_one_device(gen, tmp_path):
    """Two gloo sp ranks sharing the card (position chunks of 32) against
    the one-device forward through the same kernels, across the chunk
    boundary: within LOGIT_RTOL x max (the combine sums in another
    order)."""
    import pickle

    import torch.multiprocessing as mp

    from distributed_llama_tpu_torch.parallel.mesh import free_port

    out = tmp_path / "sp2.pkl"
    mp.start_processes(_sp_card_rank, args=(2, free_port(), str(out)),
                       nprocs=2, start_method="spawn")
    with open(out, "rb") as fh:
        got = pickle.load(fh)
    model = llama.Llama(TP_SPEC, llama.params_to_device(
        synth_params(TP_SPEC, True, seed=3), "cuda"))
    cache = llama.init_cache(TP_SPEC, "cuda")
    with torch.inference_mode():
        want = [model(cache, t, p).cpu() for t, p in SP_CALLS]
    for a, b in zip(got, want):
        err = (a - b).abs().max().item()
        assert err <= llama.LOGIT_RTOL * b.abs().max().item(), err


def test_serve_tp2_gloo_on_the_card_serves_the_tp1_tokens(gen, tmp_path):
    """``serve --tp 2`` on one card (gloo ranks sharing it, rank 0
    sending each dispatch's plan) against ``serve`` on one device: four
    concurrent greedy requests give the same tokens, the follower follows
    every plan, and both exit 0 on SIGTERM."""
    import json
    import re
    import signal
    import subprocess
    import sys
    import threading
    import urllib.request
    from pathlib import Path

    from distributed_llama_tpu_torch.io.loader import write_model

    model = tmp_path / "m.bin"
    write_model(str(model), TP_SPEC, synth_params(TP_SPEC, True, seed=3))
    tok = _serve_tokenizer(tmp_path / "t.bin", TP_SPEC.vocab_size)
    root = Path(__file__).resolve().parents[1]
    prompts = [" ".join(f"w{4 + (7 * i + j) % 500}" for j in range(n))
               for i, n in enumerate((3, 9, 17, 6))]

    def serve(extra):
        proc = subprocess.Popen(
            [sys.executable, "-m", "distributed_llama_tpu_torch", "serve",
             "--model", str(model), "--tokenizer", tok, "--port", "0",
             "--slots", "4", "--kv-page-size", "8", "--prefill-chunk", "8",
             "--temperature", "0", "--seed", "1", *extra], cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        port, head = None, []
        for line in proc.stdout:
            head.append(line)
            m = re.search(r"serving on http://[\d.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
            if port and ("🌐 tp:" in line or not extra):
                break
        out = [None] * len(prompts)

        def go(i):
            rq = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps({"prompt": prompts[i], "steps": 40}).encode())
            with urllib.request.urlopen(rq, timeout=300) as r:
                out[i] = json.loads(r.read())["tokens"]

        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        proc.send_signal(signal.SIGTERM)
        rest = "".join(head) + proc.stdout.read()
        assert proc.wait(120) == 0, rest
        return out, rest

    one, _ = serve([])
    two, rest = serve(["--tp", "2"])
    assert two == one
    assert "ranks over gloo sharing" in rest or \
        torch.cuda.device_count() >= 2, rest
    sent = re.search(r"sent (\d+) dispatch plans", rest).group(1)
    assert f"followed {sent} plans" in rest


SERVER_CASES = {  # label -> the server's engine options, paged f32
    "step": {},
    "chain4": {"block_steps": 4},
    "verify": {"spec_k": 4},
    "mixed": {"dispatch_tokens": 7},
}


def _serve_tokenizer(path, vocab):
    from distributed_llama_tpu_torch.io.tokenizer import write_tokenizer

    pieces = [b"<unk>", b"<s>", b"</s>", b" "]
    pieces += [f"w{i}".encode() for i in range(len(pieces), vocab)]
    write_tokenizer(str(path), pieces, [0.0] * len(pieces))
    return str(path)


@pytest.mark.parametrize("case", sorted(SERVER_CASES))
def test_server_with_graphs_on_its_scheduler_serves_the_eager_streams(
        gen, case, tmp_path):
    """An in-process InferenceServer on the card captures its engine's
    graphs on its scheduler thread (ContinuousEngine.capture_graphs, before
    the listener opens) while another thread reads /health's payload and
    the /metrics exposition without pause; then six concurrent clients
    (three streamed; greedy and seeded) get from it the token streams an
    eager (graph=False) server gives them, bit for bit. No prompt shares a
    page with another, so no row's computation depends on the schedule."""
    import json
    import threading
    import urllib.request

    from distributed_llama_tpu_torch.io.tokenizer import Tokenizer
    from distributed_llama_tpu_torch.runtime.server import InferenceServer

    spec = _small_spec(seq_len=64)
    params = llama.params_to_device(synth_params(spec, q40=True, seed=5,
                                                 scale=0.3), "cuda")
    tok = Tokenizer(_serve_tokenizer(tmp_path / "t.bin", spec.vocab_size),
                    spec.vocab_size)
    rng = np.random.default_rng(3)
    prompts = [" ".join(f"w{t}" for t in rng.integers(4, spec.vocab_size, n))
               for n in (3, 9, 5, 13, 2, 7)]
    bodies = [{"prompt": p, "steps": 40, "stream": i % 2 == 1,
               "temperature": 0.0 if i < 3 else 0.8, "seed": 100 + i}
              for i, p in enumerate(prompts)]

    def serve(graph):
        srv = InferenceServer(spec, params, tok, "127.0.0.1", 0, 3, 40, 0.0,
                              0.9, 1, page_size=8, prefill_chunk=4,
                              quiet=True, device="cuda", graph=graph,
                              **SERVER_CASES[case])
        stop, reads = threading.Event(), [0]

        def hammer():  # host reads only: they must not break a capture
            while not stop.is_set():
                srv._health_payload()
                srv.registry.expose()
                reads[0] += 1

        t = threading.Thread(target=hammer)
        t.start()
        try:
            srv.start()
        finally:
            stop.set()
            t.join()
        assert reads[0] > 0
        if graph:
            assert srv.engine.graph_replays == 0 and (
                srv.engine._once or srv.engine._chains
                or srv.engine._windows)

        def ask(body):
            rq = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/generate",
                data=json.dumps(body).encode())
            with urllib.request.urlopen(rq, timeout=300) as r:
                if not body["stream"]:
                    return json.loads(r.read())["tokens"]
                lines = [json.loads(ln) for ln in r]
            assert lines[-1]["done"] and "error" not in lines[-1]
            return [ln["token"] for ln in lines[:-1]]

        outs = [None] * len(bodies)

        def client(i):
            outs[i] = ask(bodies[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        health = srv._health_payload()
        srv.stop()
        assert health["state"] == "serving" and health["paged_kv"]
        return outs

    captured, eager = serve(True), serve(False)
    assert all(o is not None and len(o) > 4 for o in captured)
    assert captured == eager


# ---------------------------------------------------------------------------
# the KV tiers on the card (runtime/kv_io.py): pinned host slab, copies on
# a copy stream, captures beside promotions in flight
# ---------------------------------------------------------------------------

TIER_PAGE = 8


def _tier_prompts(n, seed=11):
    """Prompts with two full pages of their own (page 8) and a tail."""
    rng = np.random.default_rng(seed)
    return [[1, *rng.integers(4, 290, 2 * TIER_PAGE + 3)] for _ in range(n)]


def _tier_engine(spec, params, **kw):
    from distributed_llama_tpu_torch.runtime.continuous import \
        ContinuousEngine

    base = dict(page_size=TIER_PAGE, prefill_chunk=4, device="cuda")
    base.update(kw)
    return ContinuousEngine(spec, params, 2, 0.0, 0.9, 1, **base)


def _drain(eng, k):
    for _ in range(500):
        if not eng.step_many(k):
            return
    raise AssertionError("the engine never drained")


def test_capture_while_promotions_in_flight_replays_the_eager_streams(
        gen, tmp_path, monkeypatch):
    """Promotions in flight while the engine captures its 4-step chain
    graph lazily: the uploader's gate opens only once the capture has
    begun, and the capture waits until the uploader has staged disk
    payloads into pinned memory inside it. A CUDA call from that thread
    would fail the global-mode capture; the capture completes, and once
    the uploads land the replays give the eager engine's streams, and
    the untiered engine's."""
    import threading
    import time

    spec = _small_spec(seq_len=64)
    params = llama.params_to_device(synth_params(spec, q40=True, seed=5,
                                                 scale=0.3), "cuda")
    prompts = _tier_prompts(4)

    def run(graph, tiered):
        kw = (dict(kv_pages=12, kv_host_pages=2,
                   kv_disk_dir=str(tmp_path / f"d{graph}"))
              if tiered else dict(kv_pages=40))
        eng = _tier_engine(spec, params, graph=graph, **kw)
        first, _ = eng.run(prompts, 40)
        if not tiered:
            again, _ = eng.run(prompts, 40)
            return first, again
        a = eng.allocator
        a.demote_cold(len(a.tree))
        assert a.tier_page_counts()["hbm"] == 0
        assert a.tier_page_counts()["disk"] > 0
        gate = threading.Event()
        eng._uploader.gate = gate
        from distributed_llama_tpu_torch.runtime.continuous import Request

        seen = {"in_capture": False, "staged_in_capture": 0, "pending": 0}
        stage = eng._uploader._stage

        def staging(job):
            out = stage(job)
            if seen["in_capture"]:
                seen["staged_in_capture"] += 1
            return out

        eng._uploader._stage = staging
        begin = torch.cuda.CUDAGraph.capture_begin

        def capture_begin(self, *args, **kwargs):
            begin(self, *args, **kwargs)
            if gate.is_set():
                return
            # the capture has begun: let the uploader stage beside it
            seen["pending"] = sum(not s.free and s.await_promo
                                  for s in eng._pool)
            seen["in_capture"] = True
            gate.set()
            deadline = time.monotonic() + 30
            while (not seen["staged_in_capture"]
                   and time.monotonic() < deadline):
                time.sleep(0.001)

        monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin",
                            capture_begin)
        reqs = [eng.submit(Request(tokens=list(p), steps=40))
                for p in prompts]
        assert (4, True) not in eng._chains
        eng.step_many(4)  # admits, promotes, captures the 4-step chain
        seen["in_capture"] = False
        monkeypatch.undo()
        if graph:
            assert eng._chains[(4, True)].graph._graph is not None
            assert seen["pending"] > 0 and seen["staged_in_capture"] > 0
        gate.set()
        _drain(eng, 4)
        assert eng.audit_pages() == []
        assert sum(a.promotions.values()) > 0
        assert not eng.page_io.inflight and eng.page_io.upload_ms
        eng.close()
        return first, [r.out for r in reqs]

    captured, eager, plain = run(True, True), run(False, True), \
        run(False, False)
    assert captured == eager == plain


@pytest.mark.parametrize("quant", ["f32", "q8"])
@pytest.mark.parametrize("tier", ["host", "disk"])
def test_demote_promote_round_trip_on_the_card(gen, tmp_path, quant, tier):
    """A page a dispatch wrote just before its demotion (the write still
    queued on the main stream) reads back to the host after the write,
    and its promotion lands in a zeroed pool page bitwise (f32) and
    code-exact (Q8); the main stream waits on the copy stream's event."""
    from distributed_llama_tpu_torch.runtime.kv_io import PageIO
    from distributed_llama_tpu_torch.runtime.paging import PagedAllocator

    spec = _small_spec(seq_len=64)
    cache = (llama.init_cache_paged(spec, 6, TIER_PAGE, "cuda")
             if quant == "f32" else
             llama.init_cache_paged_q8(spec, 6, TIER_PAGE, "cuda"))
    io = PageIO(cache, "cuda", host_pages=2)
    kw = ({"host_pages": 2, "host_slab": io.slab, "host_layout": io.layout}
          if tier == "host" else {"disk_dir": str(tmp_path)})
    alloc = PagedAllocator(5, TIER_PAGE, **kw)
    alloc.bind_device_io(io.fetch, stage=io.stage_inline,
                         fetch_into=io.fetch_into)
    pid = alloc.alloc_page()
    alloc.insert_prefix(list(range(TIER_PAGE)), [pid])
    alloc.release_pages([pid])
    for plane in cache:  # the "dispatch": queued, not synchronized
        fill = torch.randn(plane[:, pid].shape, device="cuda",
                           generator=gen) * 40
        plane[:, pid].copy_(fill.to(plane.dtype))
    assert alloc.demote_cold(1) == 1
    want = llama.fetch_page_planes(cache, pid)
    if tier == "host":
        got = alloc.host.load(0)
        assert np.shares_memory(got[0], io.slab)
        assert all(a.tobytes() == b.tobytes() for a, b in zip(got, want))
    for plane in cache:
        plane[:, pid].zero_()
    shared = alloc.match_prefix(list(range(TIER_PAGE)) + [0])
    assert len(shared) == 1 and alloc.slot_pending(shared)
    for _ in range(1000):
        if io.settle(alloc) or not alloc.slot_pending(shared):
            break
    assert not alloc.slot_pending(shared)
    back = llama.fetch_page_planes(cache, shared[0])
    assert all(a.tobytes() == b.tobytes() for a, b in zip(want, back))
    assert io.upload_ms and all(ms >= 0 for ms in io.upload_ms)
    alloc.release_pages(shared)
    assert alloc.audit([]) == []


def test_host_tier_is_one_pinned_slab(gen, tmp_path):
    """The host tier is one pinned allocation made with the engine: every
    live host payload views it, and it is never reallocated."""
    spec = _small_spec(seq_len=64)
    params = llama.params_to_device(synth_params(spec, q40=True, seed=5,
                                                 scale=0.3), "cuda")
    eng = _tier_engine(spec, params, kv_pages=10, kv_host_pages=6)
    io = eng.page_io
    assert io._slab_t.is_pinned() and io._stage_t.is_pinned()
    ptr = io._slab_t.data_ptr()
    assert io.pinned_bytes == (6 + 4 + 1) * io.page_bytes
    prompts = _tier_prompts(6)
    eng.run(prompts, 40)
    eng.run(prompts, 40)
    a = eng.allocator
    assert a.demotions["host"] > 0 and a.promotions["host"] > 0
    assert io._slab_t.data_ptr() == ptr
    for hid in a.host.live_ids():
        assert all(np.shares_memory(p, io.slab) for p in a.host.load(hid))
    assert eng.audit_pages() == []
    eng.close()


def test_a_failed_promotion_copy_raises(gen, tmp_path, monkeypatch):
    """A copy that fails on the card raises out of the step: nothing
    falls back to the host or carries on without the page."""
    from distributed_llama_tpu_torch.runtime import kv_io
    from distributed_llama_tpu_torch.runtime.continuous import Request

    spec = _small_spec(seq_len=64)
    params = llama.params_to_device(synth_params(spec, q40=True, seed=5,
                                                 scale=0.3), "cuda")
    eng = _tier_engine(spec, params, kv_pages=10,
                       kv_disk_dir=str(tmp_path))
    prompts = _tier_prompts(2)
    eng.run(prompts, 40)
    assert eng.allocator.demote_cold(len(eng.allocator.tree)) > 0

    def broken(self, job, planes):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered (injected)")

    monkeypatch.setattr(kv_io.PageIO, "launch", broken)
    eng.submit(Request(tokens=list(prompts[0]), steps=40))
    with pytest.raises(RuntimeError, match="injected"):
        _drain(eng, 1)
    eng.close()


def _chaos_factory(**kw):
    """loadcheck's drill factory (the JAX tests' spec, f32 weights) on the
    card."""
    import argparse

    from distributed_llama_tpu_torch.tools.loadcheck import \
        build_engine_factory

    args = dict(slots=4, page_size=4, kv_pages=20, spec_k=0, seed=7,
                block_steps=1, device="cuda")
    args.update(kw)
    return build_engine_factory(argparse.Namespace(**args))


@pytest.mark.parametrize("block_steps", [1, 4])
def test_profiler_drill_captures_every_graph_before_the_profiler(
        gen, monkeypatch, block_steps):
    """profiler_under_load on the card: the drill captures every graph its
    workload replays (ContinuousEngine.capture_graphs) before
    start_capture, so no capture begins while the profiler's thread runs;
    serving does not stall and the capture stops cleanly."""
    from distributed_llama_tpu_torch.obs import profiler
    from distributed_llama_tpu_torch.runtime import chaos, decode

    seen = {"profiling": False, "captures_while": 0}
    start = profiler.start_capture
    capture = decode.GraphStep._capture

    def starting(*args, **kwargs):
        seen["profiling"] = True
        return start(*args, **kwargs)

    def capturing(self, *args, **kwargs):
        if seen["profiling"]:
            seen["captures_while"] += 1
        return capture(self, *args, **kwargs)

    monkeypatch.setattr(profiler, "start_capture", starting)
    monkeypatch.setattr(decode.GraphStep, "_capture", capturing)
    res = chaos.run_drills(_chaos_factory(block_steps=block_steps),
                           which={"profiler_under_load"}, device="cuda")
    assert res[0].passed, res[0].violations
    assert seen["profiling"] and seen["captures_while"] == 0


def test_drill_suite_green_on_the_card(gen):
    """All twelve drills on the card at the JAX tests' spec, the process
    drills' engines (and the recovery child) on the card too, the killed
    handoff pool torn down without a leak; then each mutation arm turns
    its drill red."""
    from distributed_llama_tpu_torch.runtime import chaos

    results = chaos.run_drills(_chaos_factory(), device="cuda")
    assert [r.name for r in results] == [n for n, _ in chaos.DRILLS]
    assert all(r.passed for r in results), [
        (r.name, r.violations) for r in results if not r.passed]
    mem = next(r for r in results
               if r.name == "kill_mid_handoff").details["memory"]
    # the killed decode pool went whole: its pinned buffers dropped at
    # close, and the kill released at least what the fresh pool allocates
    assert mem["killed_pool_pinned_after_close"] == 0
    assert mem["killed_pool_released"] >= mem["restarted_pool_allocated"] > 0
    for inject, drill in (("corrupt-journal", "kill_mid_decode"),
                          ("drop-page-in-flight", "kill_mid_handoff")):
        red = chaos.run_drills(_chaos_factory(), which={drill},
                               inject={inject}, device="cuda")
        assert not red[0].passed, inject
