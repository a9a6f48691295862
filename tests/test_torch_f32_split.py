"""The 3xTF32 arithmetic of the f32 parity-prefill kernels (K3, K4) and
their split plans, on the CPU.

* The Q40 weight split: every weight value (code - 8) * d16, for each of
  the 16 codes and every finite f16 scale, is w_hi + w_lo exactly, both
  parts TF32 values (their low 13 mantissa bits zero): K3 dequantizes into
  two A sets with no rounding of the weight.
* ``ops/q40.q40_matmul_tf32_model`` and
  ``ops/attention.prefill_attention_tf32_splits``, plain models of K3's and
  K4's rounding, against the JAX package's f32 ``q40_matmul`` and
  ``prefill_attention`` (Precision.HIGHEST) in interpret mode, within the
  kernels' own tolerances ``KERNEL_RTOL`` and ``KERNEL_ATOL``: GQA, bf16
  caches and K4's key splits included.
* ``ops/q40.gemm_tf32_plan`` (K3's split K) and ``ops/attention.prefill_plan``
  (K4's split of the key range) put every Q40 block, and every live key
  tile, in exactly one split, and fill an H100's SMs at 7B's widths.
"""

import numpy as np
import pytest
import torch

from distributed_llama_tpu_torch.ops import attention, q40

SMS = 132  # an H100 SXM's SMs


def _low13(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32) & 0x1FFF


def test_tf32_round_is_nearest_ties_away():
    """tf32_round on hand-picked bit patterns: below, at and above half a
    TF32 unit, both signs, a carry into the exponent."""
    bits = torch.tensor([0x3F800FFF, 0x3F801000, 0x3F801001, 0x3F803000,
                         0x3FFFF000, 0x7F7FF000], dtype=torch.int32)
    want = torch.tensor([0x3F800000, 0x3F802000, 0x3F802000, 0x3F804000,
                         0x40000000, 0x7F800000], dtype=torch.int32)
    for sign in (0, -0x80000000):
        got = q40.tf32_round((bits | sign).view(torch.float32))
        assert torch.equal(got.view(torch.int32), want | sign)


@pytest.mark.parametrize("code", range(16))
def test_q40_weight_splits_exactly(code):
    h = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    d16 = h.view(torch.float16)
    d16 = d16[torch.isfinite(d16)].to(torch.float32)
    assert d16.numel() == (1 << 16) - 2 * 1024  # every finite f16
    w = (code - 8) * d16  # exact in f32: at most 4 + 11 significant bits
    hi, lo = q40.tf32_split(w)
    assert torch.equal(hi + lo, w)
    assert torch.equal(w - hi, lo)  # the kernel's lo = w - hi, no rounding
    assert not _low13(hi).any() and not _low13(lo).any()


def test_x_split_drops_at_most_2_to_the_minus_22():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1 << 16)
                         .astype(np.float32))
    hi, lo = q40.tf32_split(x)
    assert not _low13(hi).any() and not _low13(lo).any()
    assert ((hi + lo - x).abs() <= 2.0 ** -22 * x.abs()).all()


def _ref_q40(d, n, seed):
    from distributed_llama_tpu.io.loader import Q40Weight as RefQ40
    from distributed_llama_tpu.ops.quants import quantize_q40

    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d, n)) * 0.3).astype(np.float32)
    return RefQ40(*quantize_q40(w))


@pytest.mark.parametrize("t", [9, 16, 24, 40])
def test_k3_model_matches_the_jax_f32_gemm(t):
    """K3's 3xTF32 arithmetic against the JAX package's T > 8 f32 body
    (_kernel -> _matmul_body at Precision.HIGHEST) in interpret mode,
    within K3's KERNEL_RTOL of the reference's largest magnitude."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_q40 import q40_matmul as ref
    from distributed_llama_tpu_torch.io.loader import Q40Weight

    w = _ref_q40(128, 512, seed=t)
    x = np.random.default_rng(t).standard_normal((t, 512)).astype(np.float32)
    want = np.asarray(ref(w, jnp.asarray(x), interpret=True))
    got = q40.q40_matmul_tf32_model(
        Q40Weight(torch.from_numpy(w.qs), torch.from_numpy(w.d16)),
        torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (t, 128)
    assert np.abs(got - want).max() <= q40.KERNEL_RTOL * np.abs(want).max()


def test_k3_model_error_is_that_of_the_x_split():
    """Against f64 on random Q40 weights at 7B's w2 depth (n = 11008), the
    model stays ~1e-6 of max|out|, two orders inside KERNEL_RTOL."""
    g = torch.Generator().manual_seed(3)
    w = q40.random_q40(64, 11008, "cpu", g)
    x = torch.randn((16, 11008), generator=g)
    got = q40.q40_matmul_tf32_model(w, x).double()
    from distributed_llama_tpu_torch.ops.quants import dequantize_q40_torch

    want = x.double() @ dequantize_q40_torch(w.qs, w.d16).double().T
    assert (got - want).abs().max() <= 1e-2 * q40.KERNEL_RTOL * \
        want.abs().max()


# K4's arithmetic against the JAX kernel: the live prefix (256 keys) is 8
# tiles of 32 keys; the JAX kernel walks it in one 512-key block
S, N_KV, HS, T_LEN, POS = 512, 2, 128, 16, 240


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("kv_mul", [1, 8])
@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_k4_model_matches_the_jax_f32_prefill(splits, kv_mul, cache):
    """K4's 3xTF32 split arithmetic against the JAX package's f32
    ``prefill_attention`` (both dots at Precision.HIGHEST) in interpret
    mode on N(0, 1) inputs at hs 128, GQA and a bf16 cache included,
    within K4's KERNEL_ATOL."""
    import jax.numpy as jnp

    from distributed_llama_tpu.ops.pallas_attention import \
        prefill_attention as ref

    rng = np.random.default_rng(10 * kv_mul + splits)
    k_all, v_all = (rng.normal(size=(2, S, N_KV, HS)).astype(np.float32)
                    for _ in range(2))
    q = rng.normal(size=(T_LEN, N_KV * kv_mul, HS)).astype(np.float32)
    dt = torch.bfloat16 if cache == "bf16" else torch.float32
    jdt = jnp.bfloat16 if cache == "bf16" else jnp.float32
    layer = 1
    want = np.asarray(ref(jnp.asarray(q),
                          jnp.asarray(k_all[layer]).astype(jdt),
                          jnp.asarray(v_all[layer]).astype(jdt), POS,
                          kv_mul=kv_mul, interpret=True))
    got = attention.prefill_attention_tf32_splits(
        torch.from_numpy(q), torch.from_numpy(k_all).to(dt),
        torch.from_numpy(v_all).to(dt), layer, POS, kv_mul, splits)
    assert got.shape == (T_LEN, N_KV * kv_mul * HS)
    err = np.abs(got.numpy() - want.reshape(T_LEN, -1)).max()
    assert err <= attention.KERNEL_ATOL, err


def test_k4_model_at_a_long_prefix_matches_plain():
    """At pos 1920 (the smoke's deepest case) over 4 splits, the model
    against the port's plain f32 version: the split and the 3xTF32 dots
    stay inside KERNEL_ATOL over 2048 keys."""
    g = torch.Generator().manual_seed(7)
    k_all, v_all = (torch.randn((1, 2048, 2, HS), generator=g)
                    for _ in range(2))
    q = torch.randn((128, 2, HS), generator=g)
    got = attention.prefill_attention_tf32_splits(q, k_all, v_all, 0, 1920,
                                                  1, 4)
    want = attention.prefill_attention_plain(q, k_all, v_all, 0, 1920, 1)
    assert (got - want).abs().max().item() <= attention.KERNEL_ATOL


def _runs(n, splits, per):
    """The [lo, hi) runs of `splits` splits of `per` units over n units."""
    return [(z * per, min(n, (z + 1) * per)) for z in range(splits)]


def _covers_once(runs, n):
    units = [u for lo, hi in runs for u in range(lo, hi)]
    return all(hi > lo for lo, hi in runs) and units == list(range(n))


@pytest.mark.parametrize("t", [9, 16, 32, 100, 128, 300])
@pytest.mark.parametrize("d,n", [(1, 32), (33, 32 * 129), (4096, 4096),
                                 (12288, 4096), (22016, 4096),
                                 (4096, 11008), (32000, 4096)])
def test_gemm_tf32_plan_puts_every_block_in_one_split(t, d, n):
    nb = n // 32  # K3's stages are one Q40 block each
    splits, per, wg = q40.gemm_tf32_plan(t, d, nb, SMS)
    wgs = q40.gemm_tf32_warpgroups(t)  # 2 only for a 128-token tile
    assert wg in wgs and wgs == ((2,) if t > 64 else (2, 3))
    assert _covers_once(_runs(nb, splits, per), nb)
    # the kernel cuts its own runs from the split count
    assert _covers_once(_runs(nb, splits, -(-nb // splits)), nb)
    assert 1 <= splits <= min(nb, q40.GEMM_BF16_MAX_SPLITS)
    if splits > 1:
        assert per >= q40.GEMM_BF16_MIN_BLOCKS
    fills = q40.gemm_bf16_tile(t) != q40.GEMM_TF32_SPLIT_FULL_TILE and any(
        q40.gemm_bf16_blocks(t, d, other) >= SMS for other in wgs)
    if fills:
        assert splits == 1  # a grid that fills the card stays unsplit

    def cost(s, w):  # no other plan in range is modelled faster
        return q40._gemm_bf16_cost(q40.gemm_bf16_blocks(t, d, w), nb, s,
                                   q40.GEMM_TF32_WG_COST[w], SMS,
                                   q40.GEMM_TF32_WAVE_STAGES)

    for s in range(1, 2 if fills else max(1, min(8, nb // 16)) + 1):
        for other in wgs:
            assert cost(splits, wg) <= cost(s, other)


@pytest.mark.parametrize("t", [16, 32, 128])
def test_gemm_tf32_plan_at_7b_widths(t):
    """The plans tools/plan_sweep.py measured fastest or within 4% on the
    H100 at T = 16, 32 (continuous admission) and 128, with the split-K
    sum. Up to T = 64: wqkv in 3-warpgroup blocks split in 2 (128
    blocks), wo in 2-warpgroup blocks split in 4 (128), w13 in 3-warpgroup
    blocks unsplit (115), w2 in 3-warpgroup blocks split in 6 (132). At a
    128-token tile (2-warpgroup blocks only): wqkv, wo and w2 split in 4
    (384, 128 and 128 blocks), w13 in 3 (516)."""
    got = [q40.gemm_tf32_plan(t, d, n // 32, SMS)
           for d, n in ((12288, 4096), (4096, 4096), (22016, 4096),
                        (4096, 11008))]
    assert [(splits, wg) for splits, _, wg in got] == (
        [(4, 2), (4, 2), (3, 2), (4, 2)] if t > 64
        else [(2, 3), (4, 2), (1, 3), (6, 3)])


ATT_CASES = [(pos, t, kv_mul, n_kv)
             for pos in (0, 5, 64, 384, 1920)
             for t, kv_mul, n_kv in ((2, 1, 2), (32, 1, 32), (37, 1, 32),
                                     (128, 1, 32), (128, 8, 8), (70, 4, 2))]


@pytest.mark.parametrize("pos,t,kv_mul,n_kv", ATT_CASES)
def test_prefill_plan_puts_every_tile_in_one_split(pos, t, kv_mul, n_kv):
    splits, per = attention.prefill_plan(pos, t, kv_mul, n_kv, SMS)
    tiles = -(-(pos + t) // attention.PREFILL_KEYS)
    assert _covers_once(_runs(tiles, splits, per), tiles)
    assert 1 <= splits <= min(tiles, attention.PREFILL_BF16_MAX_SPLITS)
    grid = n_kv * -(-(t * kv_mul) // attention.PREFILL_BF16_ITEMS)
    assert grid * splits <= max(grid, SMS)  # one wave, or no split
    assert per == -(-tiles // splits)  # the cut the kernel is given


def test_prefill_plan_fills_the_card_at_7b():
    """7B, T = 128: 64 blocks in 2 splits (128 blocks: the fastest of a
    sweep on the H100 at pos 384 and 1920), the GQA shape's 128 blocks
    unsplit; at T = 32 (admission) 32 blocks in 4 splits, or one a tile
    while the prefix holds fewer than 4."""
    assert attention.prefill_plan(384, 128, 1, 32, SMS) == (2, 8)
    assert attention.prefill_plan(1920, 128, 1, 32, SMS) == (2, 32)
    assert attention.prefill_plan(1920, 128, 8, 8, SMS) == (1, 64)
    assert attention.prefill_plan(224, 32, 1, 32, SMS) == (4, 2)
    assert attention.prefill_plan(64, 32, 1, 32, SMS) == (3, 1)
    assert attention.prefill_plan(0, 2, 1, 2, SMS) == (1, 1)


def test_prefill_check_takes_head_sizes_in_multiples_of_8():
    """K4's k8 steps and n8 dim tiles need hs % 8 == 0: the wrapper's check
    says so before any launch (the plain version takes any hs)."""
    q, kv = torch.zeros((4, 2, 12)), torch.zeros((1, 16, 2, 12))
    with pytest.raises(ValueError, match="multiple of 8"):
        attention._check_prefill(q, kv, kv, 0, 0, 1)
    attention._check_prefill(torch.zeros((4, 2, 16)),
                             torch.zeros((1, 16, 2, 16)),
                             torch.zeros((1, 16, 2, 16)), 0, 0, 1)
    assert attention.prefill_attention(q, kv, kv, 0, 0, 1).shape == (4, 24)


def test_plan_sweep_needs_a_card(capsys):
    """tools/plan_sweep.py times on the card only: without one it says so
    and exits 1, launching nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the sweep would run")
    from distributed_llama_tpu_torch.tools import plan_sweep

    before = q40.KERNEL_GEMM.launches
    assert plan_sweep.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().out
    assert q40.KERNEL_GEMM.launches == before
